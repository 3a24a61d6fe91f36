"""ResNet v1 trunks in plain torch.nn (NCHW).

Port of salve_tpu/models/resnet.py with the torchvision layout of the
reference's trunks (salve/models/resnet_factory.py): basic blocks stride on
conv1, bottleneck blocks on the 3x3 conv2, a projection shortcut
(`downsample.0/1`) wherever the block changes shape. Convolutions run
through `F.conv2d`/cuDNN, as the JAX package leaves them to XLA.

Batch norm trains as Flax's `nn.BatchNorm(momentum=0.9, epsilon=1e-5)`
does (salve_tpu/models/resnet.py:98-104), see `FlaxBatchNorm2d`; on a mesh
of more than one rank, over the global batch (`global_batch_statistics`).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional

import torch
from torch import nn

from salve_tpu_torch.parallel.mesh import Mesh, all_reduce_sum

_DIMS = (0, 2, 3)


def _per_channel(t: torch.Tensor) -> torch.Tensor:
    return t[None, :, None, None]


class _GlobalBatchNorm(torch.autograd.Function):
    """Training batch norm over the global batch of a mesh, as Flax computes
    it for a batch sharded under jit (flax/linen/normalization.py:
    `_compute_stats` with its fast variance, then `_normalize`).

    Each rank's per-channel mean and mean of squares (float32 at least) are
    averaged over the equal shards by one all-reduce; var = max(0, E[x^2] -
    E[x]^2); y = (x - mean) * (rsqrt(var + eps) * scale) + bias in float32,
    returned in x's dtype. The backward all-reduces the per-channel sums of
    dy and dy * x_hat, so dx is the derivative of the sum of the ranks'
    losses; the scale's and bias's gradients stay local and join the
    parameters' gradient all-reduce.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, mesh: Mesh):
        ct = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(ct)
        moments = torch.stack([xf.mean(_DIMS), (xf * xf).mean(_DIMS)])
        all_reduce_sum(mesh, moments)
        mean, meansq = moments / mesh.size
        var = (meansq - mean * mean).clamp_min(0.0)
        invstd = torch.rsqrt(var + eps)
        out = (xf - _per_channel(mean)) * _per_channel(invstd * weight.to(ct)) + _per_channel(bias.to(ct))
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.mesh = mesh
        ctx.mark_non_differentiable(mean, var)
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x, weight, mean, invstd = ctx.saved_tensors
        ct = mean.dtype
        g = dout.to(ct)
        xhat = (x.to(ct) - _per_channel(mean)) * _per_channel(invstd)
        sums = torch.stack([g.sum(_DIMS), (g * xhat).sum(_DIMS)])
        dbias, dweight = sums[0].clone(), sums[1].clone()
        all_reduce_sum(ctx.mesh, sums)
        n = ctx.mesh.size * x.numel() // x.shape[1]
        dx = _per_channel(invstd * weight.to(ct)) * (g - _per_channel(sums[0] / n) - xhat * _per_channel(sums[1] / n))
        return dx.to(x.dtype), dweight.to(weight.dtype), dbias.to(weight.dtype), None, None


@contextlib.contextmanager
def global_batch_statistics(model: nn.Module, mesh: Optional[Mesh]) -> Iterator[None]:
    """Inside the block, every `FlaxBatchNorm2d` of `model` in training mode
    normalizes with the statistics of the global batch over `mesh` (each
    rank holding its equal shard), as salve_tpu's jitted step does for a
    sharded batch. A mesh of one (or None) changes nothing."""
    bns = [m for m in model.modules() if isinstance(m, FlaxBatchNorm2d)]
    for m in bns:
        m.mesh = mesh if mesh is not None and mesh.size > 1 else None
    try:
        yield
    finally:
        for m in bns:
            m.mesh = None

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

    With `mesh` set (`global_batch_statistics`), the batch is the global
    batch of the mesh's ranks (`_GlobalBatchNorm`), for the normalization
    and for the running statistics.
    """

    def __init__(self, c: int) -> None:
        super().__init__(c, eps=1e-5, momentum=0.1)
        self.mesh: Optional[Mesh] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.mesh is not None:
            out, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, self.mesh)
        else:
            out, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            with torch.no_grad():
                var = invstd.double().pow(-2).sub(self.eps).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(mean.to(self.running_mean.dtype) * 0.1)
            self.running_var.mul_(0.9).add_(var.to(self.running_var.dtype) * 0.1)
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

    def feature_map(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 64, H/2, W/2) stem output -> (B, feature_dim, H/32, W/32)."""
        x = self.maxpool(self.relu(self.bn1(x)))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 64, H/2, W/2) stem output -> (B, feature_dim) pooled features."""
        return self.feature_map(x).mean(dim=(2, 3))


class ResNetFeatures(ResNetTrunk):
    """A ResNet trunk with its own 3-channel stem (`conv1`, 7x7 stride 2)
    and no mean pool: (B, 3, H, W) -> (B, feature_dim, H/32, W/32). The
    depth net's trunk (salve_tpu/models/depth_net.py:_Trunk, whose stem is
    `conv_init` / `bn_init`)."""

    def __init__(self, num_layers: int) -> None:
        super().__init__(num_layers)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.feature_map(self.conv1(x))

    def stages(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(B, 3, H, W) -> the outputs of layer1 to layer4, at strides 4, 8,
        16 and 32 (HorizonNet's encoder taps, models/horizonnet.py)."""
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        out = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            out.append(x)
        return out
