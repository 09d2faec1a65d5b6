"""PyTorch/CUDA port of pytorch_nested_unet_tpu for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; every module here keeps its
counterpart's name and NHWC layout. Importing the package loads nothing heavy
and builds no kernel: CUDA kernels are compiled at first use (ops/_build.py).
"""

__version__ = "0.1.0"
