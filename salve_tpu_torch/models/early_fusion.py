"""Early-fusion verifier CNN (port of salve_tpu/models/early_fusion.py).

A ResNet trunk whose stem conv is widened to take 2/4/6 channel-concatenated
RGB renders of a hypothesis pair, with a 2-class linear head. Parameter
names follow the reference's torch model (salve/models/early_fusion.py):
the widened stem at `conv1`, the torchvision trunk at `resnet.`, the head at
`fc`; so reference checkpoints load with `strict=True` once their unused
`resnet.conv1.*` / `resnet.fc.*` entries are dropped (models/weights.py).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from salve_tpu_torch.models.resnet import ResNetTrunk, get_resnet_feature_dim

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
    bf16 over float32 parameters) and the head runs in float32.
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
        x = torch.cat(images, dim=1)
        use_bf16 = self.compute_dtype == torch.bfloat16
        with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=use_bf16):
            feats = self.resnet(self.conv1(x))
        return self.fc(feats.to(torch.float32))
