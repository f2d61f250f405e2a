"""The device rule of the port: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the current CUDA device when it is None, with its index
    ("cuda" -> "cuda:0"), so that it equals the device of the tensors made
    on it; raises when that is a CUDA device and none is available."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "adaflo_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (drivers: --device cpu) to run on "
            "the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
