"""The field's defined nonlinearities: periodic-reduction sin/cos and a
rational tanh (port of `genefaceplusplus_tpu/ops/fastmath.py`).

These polynomials are the functions the field was trained with, so they are
ported term for term; `torch.sin`/`torch.tanh` are different functions.
`torch.round` rounds half to even like `jnp.round` (the CUDA kernel uses
`rintf` for the same reason).
"""

from __future__ import annotations

import math

import torch

_INV_TWO_PI = 1.0 / (2.0 * math.pi)
_HALF_PI = 0.5 * math.pi

# odd polynomial for sin(2*pi*t), t in [-0.5, 0.5] (same constants as JAX)
_S1 = 6.2830885
_S3 = -41.3332475
_S5 = 81.4000898
_S7 = -74.6758839
_S9 = 33.1680946


def sin_reduce(x: torch.Tensor) -> torch.Tensor:
    """x / 2pi reduced to [-0.5, 0.5] (round half to even)."""
    u = x * _INV_TWO_PI
    return u - torch.round(u)


def _sin_poly(t: torch.Tensor) -> torch.Tensor:
    t2 = t * t
    return t * (_S1 + t2 * (_S3 + t2 * (_S5 + t2 * (_S7 + t2 * _S9))))


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """sin(x) via periodic reduction + degree-9 odd polynomial."""
    return _sin_poly(sin_reduce(x))


def fast_cos(x: torch.Tensor) -> torch.Tensor:
    """cos(x) = fast_sin(x + pi/2): not a separate polynomial."""
    return fast_sin(x + _HALF_PI)


def fast_tanh(x: torch.Tensor) -> torch.Tensor:
    """Clamped rational tanh approximation, max err ~3e-4."""
    x = torch.clamp(x, -7.9, 7.9)
    x2 = x * x
    num = x * (135135.0 + x2 * (17325.0 + x2 * (378.0 + x2)))
    den = 135135.0 + x2 * (62370.0 + x2 * (3150.0 + x2 * 28.0))
    return torch.clamp(num / den, -1.0, 1.0)
