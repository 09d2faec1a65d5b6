"""Predict step (counterpart of training/loop.py::make_predict_fn, :108-119).

Train and eval steps come with the training slice (ROADMAP.md queue 1).
"""

import torch

from ..data.augment import eval_transform


def make_predict_fn(model: torch.nn.Module):
    """Return predict(images_u8) -> sigmoid of the last head of the eval
    forward (val.py semantics, reference val.py:92-100).

    images_u8: (B,H,W,C) uint8 on the model's device; the result is
    (B,H,W,num_classes) float32 probabilities. Puts `model` in eval mode.
    """
    model.eval()

    @torch.inference_mode()
    def predict(images_u8: torch.Tensor) -> torch.Tensor:
        images, _ = eval_transform(images_u8)
        outputs = model(images)
        heads = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        return torch.sigmoid(heads[-1])

    return predict
