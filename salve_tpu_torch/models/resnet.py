"""ResNet v1 trunks in plain torch.nn (NCHW).

Port of salve_tpu/models/resnet.py with the torchvision layout of the
reference's trunks (salve/models/resnet_factory.py): basic blocks stride on
conv1, bottleneck blocks on the 3x3 conv2, a projection shortcut
(`downsample.0/1`) wherever the block changes shape. Convolutions run
through `F.conv2d`/cuDNN, as the JAX package leaves them to XLA.

Batch norm trains as Flax's `nn.BatchNorm(momentum=0.9, epsilon=1e-5)`
does (salve_tpu/models/resnet.py:98-104), see `FlaxBatchNorm2d`.
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


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """Batch norm with Flax's training rule; torch's in eval mode.

    Training normalizes with the batch mean and the biased batch variance
    (as torch does) and moves the running statistics as Flax does:
    `ra = 0.9 * ra + 0.1 * stat` with the BIASED variance, where
    `nn.BatchNorm2d` stores the unbiased one (n / (n - 1) larger). The
    statistics and the normalization are float32 under bf16 autocast, as
    Flax computes them in float32 for a bf16 module; the output keeps the
    input's dtype; the running statistics keep their own (float32, or
    float64 in a model cast with `.double()`). The running variance comes
    from the normalizer's own
    1 / sqrt(var + eps), so no second pass reads the activation.
    """

    def __init__(self, c: int) -> None:
        super().__init__(c, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        out, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = invstd.double().pow(-2).sub(self.eps).clamp_min(0.0).to(self.running_var.dtype)
            self.running_mean.mul_(0.9).add_(mean.to(self.running_mean.dtype) * 0.1)
            self.running_var.mul_(0.9).add_(var * 0.1)
            self.num_batches_tracked.add_(1)
        return out


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = FlaxBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = FlaxBatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, planes, 1, stride, bias=False), FlaxBatchNorm2d(planes)
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
        self.bn1 = FlaxBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = FlaxBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = FlaxBatchNorm2d(cout)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False), FlaxBatchNorm2d(cout)
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
        self.bn1 = FlaxBatchNorm2d(64)
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
