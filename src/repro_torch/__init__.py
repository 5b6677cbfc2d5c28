"""PyTorch/CUDA port of the HadaCore reproduction (``repro``).

Module names mirror ``src/repro/``: ``repro_torch.core.hadamard`` is the
twin of ``repro.core.hadamard`` and so on. The port imports torch and
numpy only -- never jax, ml_dtypes or anything of ``repro`` -- and keeps
its own copies of what it needs.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request they raise
(``repro_torch.device.resolve_device``). On a CPU tensor every kernel
wrapper runs its plain PyTorch version; on a CUDA tensor it launches the
hand-written Hopper kernel (``repro_torch/csrc/``) or raises.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
