"""Plain float32 early-fusion ResNet verifier, written from the published layout.

ResNet v1 (He et al., 2016, Table 1) with bottleneck blocks in the torchvision
layout the SALVe verifier uses: the stride on the 3x3 conv, a projection
shortcut (conv 1x1 + BN) wherever a block changes shape, and a stem conv
widened to 3 * n_images input channels (SALVe, ECCV 2022: early fusion of
the ceiling and floor renders of both panos), a 2-class linear head.

No kernel, cache or batching of the program under test; parameter names are
the torchvision layout's, so a state dict made by `benchmark/weights.py`
loads here and into the program alike.

`precision="fp8"` is the control: every conv and linear input and weight is
rounded to float8 e4m3 under a per-tensor scale to its largest value before
the float32 product, with a straight-through gradient.

`fp32_products` switches TF32 off in cuDNN and cuBLAS for the reference's
own calls (PyTorch's default lets cuDNN's convolutions use TF32), whatever
the process set before, and restores the process's settings after.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# Blocks per stage of the bottleneck ResNets (He et al., 2016, Table 1).
STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
EXPANSION = 4
BN_EPS = 1e-5
FP8_MAX = 448.0  # largest finite float8 e4m3fn


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32,
    with the gradient of the identity."""
    amax = x.detach().abs().amax().clamp_min(1e-12)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x.detach())


ROUNDING = {"fp32": None, "fp8": fp8_round}


@contextmanager
def fp32_products():
    """Full float32 convolutions and matrix products inside the block."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32 or \
                torch.get_float32_matmul_precision() != "highest":
            raise RuntimeError("the reference could not switch TF32 off")
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def layer_table(num_layers: int, n_images: int, num_classes: int) -> List[Dict]:
    """Every conv, BN and linear of the model in order:
    {"kind", "name", "cin", "cout", "k", "stride"} ("k", "stride" for convs)."""
    rows = [{"kind": "conv", "name": "conv1", "cin": 3 * n_images, "cout": 64, "k": 7, "stride": 2},
            {"kind": "bn", "name": "resnet.bn1", "c": 64}]
    cin = 64
    for i, n_blocks in enumerate(STAGE_BLOCKS[num_layers]):
        planes = 64 * 2**i
        for j in range(n_blocks):
            stride = 2 if i > 0 and j == 0 else 1
            p = f"resnet.layer{i + 1}.{j}"
            cout = planes * EXPANSION
            rows += [
                {"kind": "conv", "name": f"{p}.conv1", "cin": cin, "cout": planes, "k": 1, "stride": 1},
                {"kind": "bn", "name": f"{p}.bn1", "c": planes},
                {"kind": "conv", "name": f"{p}.conv2", "cin": planes, "cout": planes, "k": 3, "stride": stride},
                {"kind": "bn", "name": f"{p}.bn2", "c": planes},
                {"kind": "conv", "name": f"{p}.conv3", "cin": planes, "cout": cout, "k": 1, "stride": 1},
                {"kind": "bn", "name": f"{p}.bn3", "c": cout},
            ]
            if stride != 1 or cin != cout:
                rows += [
                    {"kind": "conv", "name": f"{p}.downsample.0", "cin": cin, "cout": cout, "k": 1, "stride": stride},
                    {"kind": "bn", "name": f"{p}.downsample.1", "c": cout},
                ]
            cin = cout
    rows.append({"kind": "linear", "name": "fc", "cin": cin, "cout": num_classes})
    return rows


class ReferenceVerifier:
    """Functional early-fusion ResNet over a float32 state dict.

    `forward(images, train)`: images is a sequence of (B, 3, H, W) float32
    tensors; in train mode batch norm uses the batch's mean and biased
    variance, in eval mode the running statistics. `checkpoint_blocks`
    recomputes each block in the backward pass instead of keeping its
    activations (the same arithmetic, less memory).
    """

    def __init__(self, state: Dict[str, torch.Tensor], num_layers: int, n_images: int, num_classes: int,
                 precision: str = "fp32", checkpoint_blocks: bool = False) -> None:
        if precision not in ROUNDING:
            raise ValueError(f"unknown precision {precision}")
        self.state = state
        self.num_layers = num_layers
        self.n_images = n_images
        self.num_classes = num_classes
        self.round = ROUNDING[precision]
        self.checkpoint_blocks = checkpoint_blocks

    def parameters(self) -> Dict[str, torch.Tensor]:
        """The trainable leaves (conv and linear weights, BN scale and bias,
        the head's bias), by name."""
        return {k: v for k, v in self.state.items()
                if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}

    def _conv(self, x, name, stride, pad):
        w = self.state[f"{name}.weight"]
        if self.round is not None:
            x, w = self.round(x), self.round(w)
        return F.conv2d(x, w, None, stride, pad)

    def _bn(self, x, name, train):
        s = self.state
        return F.batch_norm(x, s[f"{name}.running_mean"], s[f"{name}.running_var"], s[f"{name}.weight"],
                            s[f"{name}.bias"], training=False, eps=BN_EPS) if not train else \
            F.batch_norm(x, None, None, s[f"{name}.weight"], s[f"{name}.bias"], training=True, eps=BN_EPS)

    def _block(self, x, p, stride, has_down, train):
        y = F.relu(self._bn(self._conv(x, f"{p}.conv1", 1, 0), f"{p}.bn1", train))
        y = F.relu(self._bn(self._conv(y, f"{p}.conv2", stride, 1), f"{p}.bn2", train))
        y = self._bn(self._conv(y, f"{p}.conv3", 1, 0), f"{p}.bn3", train)
        res = self._bn(self._conv(x, f"{p}.downsample.0", stride, 0), f"{p}.downsample.1", train) if has_down else x
        return F.relu(res + y)

    def forward(self, images: Sequence[torch.Tensor], train: bool = False) -> torch.Tensor:
        x = torch.cat(list(images), dim=1).to(torch.float32)
        x = F.relu(self._bn(self._conv(x, "conv1", 2, 3), "resnet.bn1", train))
        x = F.max_pool2d(x, 3, 2, 1)
        cin = 64
        for i, n_blocks in enumerate(STAGE_BLOCKS[self.num_layers]):
            cout = 64 * 2**i * EXPANSION
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                args = (f"resnet.layer{i + 1}.{j}", stride, stride != 1 or cin != cout, train)
                if self.checkpoint_blocks and torch.is_grad_enabled():
                    x = checkpoint(self._block, x, *args, use_reentrant=False)
                else:
                    x = self._block(x, *args)
                cin = cout
        feats = x.mean(dim=(2, 3))
        w = self.state["fc.weight"]
        if self.round is not None:
            feats, w = self.round(feats), self.round(w)
        return F.linear(feats, w, self.state["fc.bias"])
