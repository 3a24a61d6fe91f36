"""Verifier weights made from the seed, on the device, in a few large calls.

The same seed and device give the same state dict, which the benchmark hands
to the program (`load_state_dict`) and, made again after the window, to the
plain reference. Names follow the torchvision layout (reference/model.py).

The draw keeps activations of the random network in a useful range in eval
and train mode alike: He-normal conv kernels, BN scales near 1 with the
last BN of each residual branch at 0.1-0.3 (so 50 blocks do not blow the
residual stream up), small BN biases, running statistics near (0, 1), and a
small head. In eval mode some seeds still drive the logit margins past
float32's resolution of a probability; the scoring driver scales the head
on data (drivers/fused_scoring.py:verifier_state).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.model import layer_table


def arch_of(config: Dict) -> Dict:
    """The layer-table keys of a configuration."""
    return {k: config[k] for k in ("num_layers", "n_images", "num_classes")}


@torch.no_grad()
def make_state_dict(arch: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 state dict of the early-fusion ResNet `arch`
    ({"num_layers", "n_images", "num_classes"}) drawn from `seed`."""
    device = torch.device(device)
    table = layer_table(arch["num_layers"], arch["n_images"], arch["num_classes"])
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 1) % (2**63 - 1))
    weights = [r for r in table if r["kind"] in ("conv", "linear")]
    sizes = [r["cout"] * r["cin"] * r.get("k", 1) ** 2 for r in weights]
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    bns = [r for r in table if r["kind"] == "bn"]
    n_bn = sum(r["c"] for r in bns)
    u = torch.rand((4, n_bn), generator=g, device=device, dtype=torch.float32)

    state: Dict[str, torch.Tensor] = {}
    for r, w in zip(weights, flat.split(sizes)):
        fan_in = r["cin"] * r.get("k", 1) ** 2
        if r["kind"] == "conv":
            state[f"{r['name']}.weight"] = w.view(r["cout"], r["cin"], r["k"], r["k"]).mul_(math.sqrt(2.0 / fan_in))
        else:
            state[f"{r['name']}.weight"] = w.view(r["cout"], r["cin"]).mul_(math.sqrt(0.16 / fan_in))
            state[f"{r['name']}.bias"] = torch.zeros(r["cout"], device=device)
    for r, (scale, bias, mean, var) in zip(bns, zip(*(t.split([b["c"] for b in bns]) for t in u))):
        last_of_branch = r["name"].endswith(".bn3")
        state[f"{r['name']}.weight"] = scale.mul(0.2).add_(0.1) if last_of_branch else scale.mul(0.4).add_(0.8)
        state[f"{r['name']}.bias"] = bias.mul(0.2).sub_(0.1)
        state[f"{r['name']}.running_mean"] = mean.mul(0.2).sub_(0.1)
        state[f"{r['name']}.running_var"] = var.mul(0.4).add_(0.8)
        state[f"{r['name']}.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
    return state
