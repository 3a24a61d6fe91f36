"""ResNet v1 trunks in plain torch.nn (NCHW).

Port of salve_tpu/models/resnet.py with the torchvision layout of the
reference's trunks (salve/models/resnet_factory.py): basic blocks stride on
conv1, bottleneck blocks on the 3x3 conv2, a projection shortcut
(`downsample.0/1`) wherever the block changes shape. Convolutions run
through `F.conv2d`/cuDNN, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
from torch import nn

# (block type, stage sizes, feature dim) per depth.
RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2), 512),
    34: ("basic", (3, 4, 6, 3), 512),
    50: ("bottleneck", (3, 4, 6, 3), 2048),
    152: ("bottleneck", (3, 8, 36, 3), 2048),
}


def get_resnet_feature_dim(num_layers: int) -> int:
    return RESNET_SPECS[num_layers][2]


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, planes, 1, stride, bias=False), _bn(planes)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(res + y)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1) -> None:
        super().__init__()
        cout = planes * 4
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = _bn(cout)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False), _bn(cout)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(res + y)


class ResNetTrunk(nn.Module):
    """ResNet trunk after the stem conv: bn1, max pool, layer1..4, mean pool.

    The stem conv itself lives on the early-fusion model (`conv1`), which
    widens it to 3 * n_images input channels, as in the reference.
    """

    def __init__(self, num_layers: int) -> None:
        super().__init__()
        kind, stage_sizes, _ = RESNET_SPECS[num_layers]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.bn1 = _bn(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(kernel_size=3, stride=2, padding=1)
        cin = 64
        for i, n_blocks in enumerate(stage_sizes):
            planes = 64 * 2**i
            blocks = []
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block(cin, planes, stride))
                cin = planes * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 64, H/2, W/2) stem output -> (B, feature_dim) pooled features."""
        x = self.maxpool(self.relu(self.bn1(x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x.mean(dim=(2, 3))
