"""grakel_torch: the PyTorch/CUDA port of grakel_tpu.

The same public surface as the JAX package, module by module, on
PyTorch tensors.  Entry points run on the CUDA card unless the caller
asks for the CPU (``with grakel_torch.use_device("cpu"): ...``); the
port never falls back to the CPU on its own.  Its hand-written CUDA
kernels (``csrc/``) build at first use with ``nvcc``.
"""

from .device import use_device
from .graph import Graph
from .batch import GraphBatch
from .kernels import *          # noqa: F401,F403
from .kernels import __all__ as _kernels_all

__version__ = "0.1.0"

__all__ = ["Graph", "GraphBatch", "use_device"] + list(_kernels_all)
