"""HoHoNet weights made from the seed, on the device, in a few large calls.

The same seed and device give the same state dict, in HoHoNet's `.pth`
key layout (reference/hohonet.py:state_shapes), which the benchmark loads
into the program with `load_state_dict(strict=True)` and, made again after
the window, hands to the plain reference.

The draw keeps the random network's activations in a useful range: He-normal
conv kernels, batch norm scales near 1, small biases and running
statistics near (0, 1), so the concatenating trunk neither dies under its
ReLU6 nor saturates; Xavier-scaled projections in the encoder; the DCT
head's constant coefficient biased to a mean depth of 2.5 m and its other
coefficients drawn so a column's depth varies by some tenths of a metre.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from benchmark.reference.hohonet import PANO_HW, state_shapes

MEAN_DEPTH_M = 2.5
# The DCT head's kernel variance times its fan-in: the coefficients of a
# column, read off a layer-normed feature, then have a variance of about
# HEAD_GAIN, and a pixel's depth a spread of about 0.25 m around the mean.
HEAD_GAIN = 0.25


@torch.no_grad()
def make_state_dict(seed: int, device, input_hw: Tuple[int, int] = PANO_HW) -> Dict[str, torch.Tensor]:
    device = torch.device(device)
    shapes = state_shapes(input_hw)
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_033 + 7) % (2**63 - 1))
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    drawn = [k for k in shapes if not k.endswith("num_batches_tracked")]
    normal = torch.randn(sum(sizes[k] for k in drawn), generator=g, device=device, dtype=torch.float32)
    uniform = torch.rand(sum(sizes[k] for k in drawn), generator=g, device=device, dtype=torch.float32)
    n_split = normal.split([sizes[k] for k in drawn])
    u_split = uniform.split([sizes[k] for k in drawn])

    state: Dict[str, torch.Tensor] = {}
    for k, n, u in zip(drawn, n_split, u_split):
        shape = shapes[k]
        n, u = n.view(shape), u.view(shape)
        if k.endswith("conv.weight") or k in ("decode.proj.weight",):
            fan_in = math.prod(shape[1:])
            state[k] = n.mul_(math.sqrt(2.0 / fan_in))
        elif k.endswith(("norm.weight", "proj_norm.weight")) or k.startswith("refine.norm"):
            state[k] = u.mul_(0.4).add_(0.8) if k.endswith("weight") else u.mul_(0.2).sub_(0.1)
        elif k.endswith(("norm.bias", "proj_norm.bias")):
            state[k] = u.mul_(0.2).sub_(0.1)
        elif k.endswith("running_mean"):
            state[k] = u.mul_(0.2).sub_(0.1)
        elif k.endswith("running_var"):
            state[k] = u.mul_(0.4).add_(0.8)
        elif k == "refine.pos_embedding":
            state[k] = n.mul_(0.02)
        elif k == "head.coef.weight":
            state[k] = n.mul_(math.sqrt(HEAD_GAIN / shape[1]))
        elif k.endswith("weight"):  # the encoder's projections
            fan_in = math.prod(shape[1:])
            state[k] = n.mul_(math.sqrt(1.0 / fan_in))
        else:  # the encoder's and the head's biases
            state[k] = u.mul_(0.02).sub_(0.01)
    for k in shapes:
        if k.endswith("num_batches_tracked"):
            state[k] = torch.zeros((), dtype=torch.long, device=device)
    state["head.coef.bias"][0] += MEAN_DEPTH_M * math.sqrt(input_hw[0])
    return {k: state[k] for k in shapes}
