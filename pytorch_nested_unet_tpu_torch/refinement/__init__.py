"""CascadePSP segmentation refinement (counterpart of refinement/; reference
segmentation-refinement/ and cascadePSP_model/): the RefinementModule, its
tiled driver and the `Refiner` front end. The reference's synchronized-BN
copy of the network is the same module (`PSPNet`)."""

from .driver import process_high_res_im, process_im_single_pass, resize_max_side, safe_forward
from .pspnet import (DilatedResNet50, PSPModule, PSPNet, PSPUpsample, RefinementModule)
from .refiner import (Refiner, WeightsUnavailable, convert_torch_state_dict,
                      export_torch_style_state_dict, load_weights)

__all__ = [
    "RefinementModule", "PSPNet", "PSPModule", "PSPUpsample", "DilatedResNet50",
    "process_high_res_im", "process_im_single_pass", "resize_max_side", "safe_forward",
    "Refiner", "WeightsUnavailable", "convert_torch_state_dict",
    "export_torch_style_state_dict", "load_weights",
]
