"""Float32 arithmetic that reproduces the JAX package's compiled numerics."""

from __future__ import annotations

import numpy as np
import torch


def div_const(x: torch.Tensor, c) -> torch.Tensor:
    """x / c for a constant c, rounded as the JAX package's jitted code rounds.

    Under `jax.jit`, XLA rewrites a division by a constant into a product
    with the constant's float32 reciprocal, which rounds differently from
    IEEE division in ~30% of elements and can move a later round(). The
    port computes the same product on every device (a CUDA divide by a
    Python scalar does this too; a CPU divide does not). `c` may be a
    scalar or a sequence broadcast against the last axis.
    """
    recip = np.float32(1.0) / np.asarray(c, dtype=np.float32)
    return x * torch.as_tensor(recip, dtype=torch.float32, device=x.device)


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
