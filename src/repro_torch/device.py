"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """The device an entry point runs on. ``None`` means the default,
    ``"cuda"``. A CUDA request without a visible GPU raises instead of
    quietly running on the CPU: the CPU runs only when asked for by name
    (the tests pass ``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on the CUDA device by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return dev
