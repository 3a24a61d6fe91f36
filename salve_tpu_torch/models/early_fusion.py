"""Early-fusion verifier CNN (port of salve_tpu/models/early_fusion.py).

A ResNet trunk whose stem conv is widened to take 2/4/6 channel-concatenated
RGB renders of a hypothesis pair, with a 2-class linear head. Parameter
names follow the reference's torch model (salve/models/early_fusion.py):
the widened stem at `conv1`, the torchvision trunk at `resnet.`, the head at
`fc`; so reference checkpoints load with `strict=True` once their unused
`resnet.conv1.*` / `resnet.fc.*` entries are dropped (models/weights.py).

A fresh model trains from `init_flax_style`'s weights, the Flax model's
initializers, not torch's defaults.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from salve_tpu_torch.models.resnet import BasicBlock, Bottleneck, ResNetTrunk, get_resnet_feature_dim

_VALID_MODALITY_SETS = [
    ({"layout"}, 2),
    ({"ceiling_rgb_texture"}, 2),
    ({"floor_rgb_texture"}, 2),
    ({"ceiling_rgb_texture", "floor_rgb_texture"}, 4),
    ({"ceiling_rgb_texture", "floor_rgb_texture", "layout"}, 6),
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def num_images_for_modalities(modalities: Sequence[str]) -> int:
    """Tuple arity (2/4/6 images) of a modality set."""
    mset = set(modalities)
    for valid, n in _VALID_MODALITY_SETS:
        if mset == valid:
            return n
    raise ValueError(f"Unsupported modalities: {sorted(mset)}")


class EarlyFusionCEResnet(nn.Module):
    """Early-fusion model for a cross-entropy loss.

    Called with a sequence of (B, 3, H, W) images, concatenated along the
    channel axis. Parameters stay float32; with compute_dtype "bfloat16" the
    stem and trunk run under bf16 autocast (as the Flax model computes in
    bf16 over float32 parameters) and the head runs in float32. A model
    cast with `.double()` (compute_dtype "float32") runs in float64
    throughout, its inputs cast to it.
    """

    def __init__(
        self,
        num_layers: int = 152,
        num_classes: int = 2,
        modalities: Tuple[str, ...] = ("ceiling_rgb_texture", "floor_rgb_texture"),
        compute_dtype: str = "bfloat16",
        append_pair_difference: bool = False,
    ) -> None:
        super().__init__()
        self.num_layers = num_layers
        self.modalities = tuple(modalities)
        self.n_images = num_images_for_modalities(modalities)
        self.compute_dtype = _DTYPES[compute_dtype]
        self.append_pair_difference = append_pair_difference
        n_in = self.n_images + (self.n_images // 2 if append_pair_difference else 0)
        self.conv1 = nn.Conv2d(3 * n_in, 64, 7, 2, 3, bias=False)
        self.resnet = ResNetTrunk(num_layers)
        self.fc = nn.Linear(get_resnet_feature_dim(num_layers), num_classes)

    def forward(self, images: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(images) != self.n_images:
            raise ValueError(
                f"Modalities {self.modalities} require {self.n_images} images, got {len(images)}"
            )
        images = list(images)
        if self.append_pair_difference:
            images += [images[i] - images[i + 1] for i in range(0, len(images), 2)]
        x = torch.cat(images, dim=1).to(self.conv1.weight.dtype)
        use_bf16 = self.compute_dtype == torch.bfloat16
        with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=use_bf16):
            feats = self.resnet(self.conv1(x))
        return self.fc(feats.to(self.fc.weight.dtype))


# jax.nn.initializers.variance_scaling's "truncated_normal": a standard
# normal truncated to [-2, 2], scaled by sqrt(variance) over that
# truncation's standard deviation.
_TRUNCATED_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """LeCun normal (variance 1 / fan_in, truncated at 2 sigma), drawn from
    `gen` as torch.nn.init.trunc_normal_ draws: inverse CDF of a uniform."""
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = torch.rand(w.shape, generator=gen, dtype=torch.float64) * (2 * hi - 2 * lo) + (2 * lo - 1)
    z = torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    w.copy_((z * (math.sqrt(1.0 / fan_in) / _TRUNCATED_STD)).to(w.dtype))


@torch.no_grad()
def init_flax_style(model: EarlyFusionCEResnet, gen: torch.Generator) -> EarlyFusionCEResnet:
    """Re-initialize `model` as salve_tpu's Flax model initializes
    (salve_tpu/models/resnet.py, early_fusion.py), drawing from `gen`:

      * every conv kernel and the head's kernel: LeCun normal (flax's
        nn.Conv / nn.Dense default), fan_in = in_channels * kh * kw;
      * the head's bias: zero;
      * batch norm: scale 1, bias 0, running mean 0, running variance 1,
        except the scale of each residual branch's last batch norm, which
        is 0 (resnet.py:50,75);

    in module order. Returns the model.
    """
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            _lecun_normal_(m.weight, m.weight[0].numel(), gen)
        elif isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.in_features, gen)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    for m in model.modules():
        if isinstance(m, BasicBlock):
            m.bn2.weight.zero_()
        elif isinstance(m, Bottleneck):
            m.bn3.weight.zero_()
    return model
