"""Fused multiply-add, ``a + b·c`` rounded once, for float32 and float64.

XLA's CPU backend contracts a multiply feeding an add into one fused
multiply-add wherever nothing stops it (the JAX package's optimization
barriers do not survive its CPU pipeline): the confidence growth
``c + (1 − c)·g`` of the fused settle program, the tie-break's
``s2/n − mean²`` and the bands' variance and ``mean ± z·stderr``. The
port computes those sites with :func:`fma` so that its plain version is
bit-equal to the reference; the CUDA kernels use the hardware's FMA.
PyTorch has no such operation, so it is emulated with error-free
transformations and a rounding "to odd" (Boldo and Melquiond, "Emulation
of FMA and correctly rounded sums: proved algorithms using rounding to
odd", IEEE Trans. Computers 57(4), 2008): the last rounding then gives
the correctly rounded result, with no double-rounding error.
"""

from __future__ import annotations

import torch

#: Veltkamp's splitting constant for float64: 2^27 + 1.
_SPLIT64 = 134217729.0


def _two_sum(a, b):
    """``(s, e)`` with s = RN(a + b) and a + b = s + e exactly."""
    s = a + b
    back = s - a
    return s, (a - (s - back)) + (b - back)


def _round_to_odd(value, error):
    """``value`` nudged to the odd neighbour toward ``value + error`` when
    the add that made it was inexact: the "round to odd" of the sum."""
    bits = torch.int32 if value.dtype == torch.float32 else torch.int64
    even = (value.view(bits) & 1) == 0
    toward = torch.where(error > 0, torch.inf, -torch.inf).to(value.dtype)
    return torch.where((error != 0) & even, torch.nextafter(value, toward), value)


def _split64(x):
    """Veltkamp split of float64 ``x`` into two 26-bit halves."""
    t = x * _SPLIT64
    high = t - (t - x)
    return high, x - high


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a + b·c`` rounded once to the inputs' dtype (float32 or float64).

    float32 goes through float64, where ``b·c`` is exact and the add is
    rounded to odd. float64 takes Dekker's exact product (valid away from
    overflow and underflow, which the engine's [0, 1] values never
    approach) and rounds the low-order sum to odd before the final add.
    """
    if a.dtype == torch.float32:
        a64, product = a.double(), b.double() * c.double()
        total, error = _two_sum(a64, product)
        return _round_to_odd(total, error).to(torch.float32)
    if a.dtype != torch.float64:
        raise TypeError(f"fma takes float32 or float64, not {a.dtype}")
    product = b * c
    bh, bl = _split64(b)
    ch, cl = _split64(c)
    product_error = ((bh * ch - product) + bh * cl + bl * ch) + bl * cl
    high, low = _two_sum(a, product)
    tail, tail_error = _two_sum(low, product_error)
    return high + _round_to_odd(tail, tail_error)
