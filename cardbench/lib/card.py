"""What a run says about its machine: the card, its power limit, the global
switches, and the modules that must never be loaded (JAX and the JAX package).
"""

import subprocess
import sys

import torch

# top-level module names a run may not load: JAX, its libraries, the JAX
# package of this repository (the port's name begins with it, so names are
# compared whole, never by prefix)
FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_nested_unet_tpu")


def forbidden_modules(modules=None):
    """Top-level names among `modules` (default sys.modules) that are
    FORBIDDEN, compared whole."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def switches() -> dict:
    return {"cudnn.benchmark": torch.backends.cudnn.benchmark,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.deterministic": torch.backends.cudnn.deterministic,
            "deterministic_algorithms": torch.are_deterministic_algorithms_enabled()}


def power_limits():
    """nvidia-smi's name and power limit of each card, or the error."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines() or [out.stderr.strip()]
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi: {e}"]


def cards_ready(chips: int):
    """None when at least `chips` CUDA cards are visible, else why not.
    Creates no context on any card."""
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return f"the cell asks for {chips} card(s); {torch.cuda.device_count()} visible"
    return None
