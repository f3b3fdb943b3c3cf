"""Device and dtype policy — the port's counterpart of ``utils/dtypes.py``.

The JAX package settles in float64 when x64 is enabled (the parity gates)
and in float32 otherwise. PyTorch has no global switch, so the port's
default is float32 and float64 is asked for per call with
``dtype=torch.float64``, the precision its parity gates run at.

The device is explicit: ``None`` means CUDA, and a machine without CUDA
raises unless the caller asked for the CPU. Nothing falls back silently.
"""

from __future__ import annotations

import torch

_FLOAT_DTYPES = (torch.float32, torch.float64)


def default_float_dtype() -> torch.dtype:
    return torch.float32


def resolve_dtype(dtype=None) -> torch.dtype:
    """``None`` → float32; float32 and float64 pass; anything else raises."""
    if dtype is None:
        return default_float_dtype()
    if dtype not in _FLOAT_DTYPES:
        raise ValueError(
            f"dtype={dtype!r}: the port settles in torch.float32 or "
            "torch.float64"
        )
    return dtype


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raises when CUDA is asked for but absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device={device!r}: expected cuda or cpu")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU"
        )
    return device
