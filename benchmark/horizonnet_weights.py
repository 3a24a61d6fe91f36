"""HorizonNet weights made from the seed, on the device, in a few large calls.

The same seed and device give the same state dict, in the released `.pth`
key layout (reference/horizonnet.py:state_shapes), which the benchmark loads
into the program with `load_state_dict(strict=True)` and, made again after
the window, hands to the plain reference.

The draw keeps the random network's activations in a useful range:
He-normal convolutions, batch norm near identity (scales near 1, the last
of each residual branch at 0.1-0.3 so that 16 blocks do not blow the
residual stream up, as benchmark/weights.py draws the verifier), small
convolution biases; the LSTM at torch's own uniform +-1/sqrt(512); the
output layer's bias as published (-1, -0.478, 0.425: the floor boundary
near row 325 of 512) and its weight unit-scaled, a row for each of the 12
outputs, for the driver to scale by one scalar (`scale_output`).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from benchmark.reference.horizonnet import HIDDEN, PANO_HW, STEP_COLS, state_shapes

# The published initialisation of the output layer's bias: corner, ceiling, floor.
LINEAR_BIAS = (-1.0, -0.478, 0.425)


@torch.no_grad()
def make_state_dict(seed: int, device, input_hw: Tuple[int, int] = PANO_HW) -> Dict[str, torch.Tensor]:
    device = torch.device(device)
    shapes = state_shapes(input_hw)
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_037 + 11) % (2**63 - 1))
    drawn = [k for k in shapes if not k.endswith("num_batches_tracked")]
    sizes = [math.prod(shapes[k]) for k in drawn]
    normal = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32).split(sizes)
    uniform = torch.rand(sum(sizes), generator=g, device=device, dtype=torch.float32).split(sizes)

    state: Dict[str, torch.Tensor] = {}
    for k, n, u in zip(drawn, normal, uniform):
        shape = shapes[k]
        n, u = n.view(shape), u.view(shape)
        if k.startswith("bi_rnn."):
            bound = 1.0 / math.sqrt(HIDDEN)
            state[k] = u.mul_(2 * bound).sub_(bound)
        elif k == "linear.weight":
            state[k] = n.mul_(math.sqrt(1.0 / shape[1]))
        elif k == "linear.bias":
            state[k] = torch.tensor(LINEAR_BIAS, device=device).repeat_interleave(STEP_COLS)
        elif len(shape) == 4:  # convolutions: He-normal
            state[k] = n.mul_(math.sqrt(2.0 / math.prod(shape[1:])))
        elif k.endswith("running_mean"):
            state[k] = u.mul_(0.2).sub_(0.1)
        elif k.endswith("running_var"):
            state[k] = u.mul_(0.4).add_(0.8)
        elif k.endswith(".bn3.weight"):
            state[k] = u.mul_(0.2).add_(0.1)
        elif k.endswith("weight"):  # batch norm scales
            state[k] = u.mul_(0.4).add_(0.8)
        else:  # batch norm shifts and the height compression's convolution biases
            state[k] = u.mul_(0.2).sub_(0.1) if "layers.1" in k or ".bn" in k or "downsample.1" in k else \
                u.mul_(0.02).sub_(0.01)
    for k in shapes:
        if k.endswith("num_batches_tracked"):
            state[k] = torch.zeros((), dtype=torch.long, device=device)
    return {k: state[k] for k in shapes}


def scale_output(state: Dict[str, torch.Tensor], scale: float) -> Dict[str, torch.Tensor]:
    """The output layer's weight scaled by `scale`, in place; returns `state`."""
    state["linear.weight"].mul_(scale)
    return state
