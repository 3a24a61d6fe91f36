"""Operations of the verifier, counted from the published architecture.

Multiply-adds of every convolution and of the head of the early-fusion
ResNet (reference/model.py's layer table, He et al. 2016 Table 1 with the
stem widened to 3 * n_images channels) at a square input; one FLOP is half
a multiply-add. Batch norm, ReLU, pooling and the residual adds are left
out, as the published counts leave them out. A training step counts three
forward passes (forward, and the backward's two products).
"""

from __future__ import annotations

from typing import Dict

from benchmark.reference.model import layer_table


def forward_macs(arch: Dict, px: int) -> int:
    side = px
    macs = 0
    for r in layer_table(arch["num_layers"], arch["n_images"], arch["num_classes"]):
        if r["kind"] == "conv":
            # conv1 (7x7/2) then the max pool (3x3/2) halve the side twice; a
            # block's stride sits on its 3x3 conv, and its projection
            # shortcut writes the block's output side.
            if r["name"] == "conv1":
                out = px // 2
            elif r["name"].endswith("downsample.0"):
                out = side
            else:
                out = -(-side // r["stride"])
            macs += out * out * r["cin"] * r["cout"] * r["k"] ** 2
            if r["name"] == "conv1":
                side = out // 2
            elif r["stride"] == 2 and r["name"].endswith("conv2"):
                side = out
        elif r["kind"] == "linear":
            macs += r["cin"] * r["cout"]
    return macs


def forward_flops(arch: Dict, px: int) -> float:
    return 2.0 * forward_macs(arch, px)
