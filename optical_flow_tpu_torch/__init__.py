"""optical_flow_tpu_torch — the Farnebäck flow model in PyTorch + CUDA.

A port of `optical_flow_tpu` (JAX/XLA/Pallas) to PyTorch, with each Pallas
TPU kernel rewritten by hand in CUDA C++ for Hopper (`csrc/`, built with
nvcc for sm_90a at first use, `kernels/_build.py`).  Entry points run on
the current CUDA card unless the caller asks for the CPU
(`utils/device.py`).

Module names mirror the JAX package so that each module's counterpart is
easy to find.  Every stage picks its implementation by the device of its
tensors: a CUDA tensor goes to the hand-written kernel, a CPU tensor to
the plain PyTorch version of the same function (`models/farneback/core.py`,
`ops/resize.py`), which is also the kernels' oracle.

Importing this package imports neither JAX nor `optical_flow_tpu`,
initialises no CUDA context and builds no kernel.
"""

__version__ = "0.1.0"

from optical_flow_tpu_torch.utils.config import FarnebackConfig, ExtractorConfig

__all__ = [
    "FarnebackConfig",
    "ExtractorConfig",
    "__version__",
]
