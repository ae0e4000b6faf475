"""Device choice for the port's entry points.

Entry points default to the CUDA card and raise when there is none;
the CPU is used only when the caller asks for it (the parity tests
do). Nothing falls back silently.
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises if a CUDA device is asked for and
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev


@contextlib.contextmanager
def cudnn_fp32():
    """Run cuDNN float32 convolutions in full float32: its default
    (``allow_tf32``) would round their inputs to TF32. Other cuDNN
    settings are left as they are."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string ("float64" / "float32") -> torch dtype."""
    return {"float64": torch.float64, "float32": torch.float32}[name]
