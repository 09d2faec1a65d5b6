"""Device selection for the port's entry points (counterpart of utils/backend.py).

Entry points run on the card unless the caller asks for the CPU. Asking for
CUDA on a host without it is an error, never a quiet fall-back to the CPU.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return `device` as a torch.device; raise if it is CUDA and none is there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions on the CPU")
    return dev
