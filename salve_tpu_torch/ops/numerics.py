"""Float32 arithmetic that reproduces the JAX package's compiled numerics.

See also `ops/libm.py` for float32 sin, cos and atan2.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def constant(values, device: torch.device) -> torch.Tensor:
    """`values` (a scalar or a sequence) as a float32 tensor on `device`,
    made once a (value, shape, device) and shared: callers must not write
    into it. Copying a host value to the card waits for the card's stream,
    so a constant made anew at every call stalls the host there, and no
    CUDA graph can capture the copy."""
    a = np.asarray(values, dtype=np.float32)
    return _constant(a.tobytes(), a.shape, torch.device(device))


@functools.lru_cache(maxsize=None)
def _constant(data: bytes, shape: tuple, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, dtype=np.float32).reshape(shape).copy()).to(device)


def div_const(x: torch.Tensor, c) -> torch.Tensor:
    """x / c for a constant c, rounded as the JAX package's jitted code rounds.

    Under `jax.jit`, XLA rewrites a division by a constant into a product
    with the constant's float32 reciprocal, which rounds differently from
    IEEE division in ~30% of elements and can move a later round(). The
    port computes the same product on every device (a CUDA divide by a
    Python scalar does this too; a CPU divide does not), with the
    reciprocal a `constant` of x's device. `c` may be a scalar or a
    sequence broadcast against the last axis.
    """
    return x * constant(reciprocal_f32(c), x.device)


def reciprocal_f32(c) -> np.ndarray:
    """The float32 reciprocal of `c` by which `div_const` multiplies."""
    return np.float32(1.0) / np.asarray(c, dtype=np.float32)


def fma_f32(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """float32 a * b + c with one rounding, as XLA's fused multiply-add.

    XLA:CPU contracts a jitted `a * b + c` into an FMA; where the result
    later meets a round() at a half-pixel tie (the NN warp's target grid),
    the separately rounded product rounds the other way. The product of two
    float32 values is exact in float64, so this rounds once up to the rare
    double rounding of the float64 sum.
    """
    b64 = float(np.float32(b))
    c64 = float(np.float32(c))
    return (a.to(torch.float64) * b64 + c64).to(torch.float32)


def fma_f32_exact(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c of three tensors, rounded once, on every device.

    The product of two float32 values is exact in float64. The float64 sum
    is rounded to odd (its error from a two-sum moves an even result one
    ulp toward the exact value), which makes the final float32 rounding
    equal to a single rounding of a * b + c.
    """
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """IEEE float32 sqrt, as XLA's. Torch's float32 sqrt on the CPU is off by
    an ulp in about 18% of inputs; a float64 root within a few ulps rounds to
    the correct float32 one, since a float32's root stays 2^-50 (relative)
    away from every float32 rounding midpoint."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)
