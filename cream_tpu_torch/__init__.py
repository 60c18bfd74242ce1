"""cream_tpu_torch: the PyTorch and CUDA port of cream_tpu for NVIDIA Hopper.

Mirrors the layout and names of the JAX package `cream_tpu`; public functions
keep its NHWC layout. Importing this package loads no CUDA code: kernels are
built with nvcc at first use (see `ops/build.py`).
"""

__version__ = "0.1.0"
