"""adaflo-tpu-torch: the PyTorch/CUDA port of adaflo-tpu.

A second package beside ``adaflo_tpu`` (the JAX reference, which stays as
it is). The port keeps the JAX package's module tree and names; plain tensor
code is PyTorch, and the Pallas kernels of ``adaflo_tpu/ops/pallas_matvec.py``
become CUDA kernels written for Hopper (``csrc/``), built with nvcc at first
use. It imports nothing of JAX or of ``adaflo_tpu``.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``, drivers: ``--device cpu``); on the CPU every kernel is
replaced by its plain PyTorch version.
"""

from adaflo_tpu_torch.parameters import FlowParameters
from adaflo_tpu_torch.time_stepping import TimeStepping, TimeSteppingScheme

__version__ = "0.1.0"

__all__ = [
    "FlowParameters",
    "TimeStepping",
    "TimeSteppingScheme",
]
