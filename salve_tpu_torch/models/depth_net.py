"""Monocular pano depth network in plain torch (port of salve_tpu/models/depth_net.py).

HoHoNet's design recipe over a ResNet trunk:

    ResNet trunk (NCHW)                    -> (C, H/32, W/32)
    height compression (column max + mean) -> (W/32, 2C) -> Dense to embed
    + a circular sin/cos position term
    transformer blocks over width          -> (W/32, embed)
    per-column decoder (Dense, reshape)    -> (H, W), two refinement convs
    softplus                               -> depth in meters

Numerics follow the Flax model rather than torch's defaults:
  * LayerNorm is Flax's: epsilon 1e-6, the fast variance E[x^2] - E[x]^2,
    statistics in float32 (`FlaxLayerNorm`);
  * GELU is the tanh approximation;
  * attention is Flax's MultiHeadDotProductAttention: separate q/k/v dense
    kernels with biases, the query divided by sqrt(head_dim) before the
    product, written as explicit matmuls and a softmax in the compute dtype;
  * at compute dtype bfloat16 the parameters stay float32 and the model
    runs under bf16 autocast, except `refine2` and the softplus, which run
    in float32 as in the Flax model.

Entry points (`make_depth_provider`, `load_depth_provider`) return a depth
producer for `depth/cache.py`: (H, W, 3) float RGB in [0, 1] -> (H, W)
float meters.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.models.early_fusion import _DTYPES, _lecun_normal_
from salve_tpu_torch.models.resnet import BasicBlock, Bottleneck, ResNetFeatures, get_resnet_feature_dim

PANO_H, PANO_W = 512, 1024
# The ResNet trunk's output stride: the decoder widens each column by it.
TRUNK_STRIDE = 32
REFINE_CHANNELS = 16


class FlaxLayerNorm(nn.Module):
    """Flax's nn.LayerNorm over the last axis: statistics in (at least)
    float32 with the fast variance max(0, E[x^2] - E[x]^2),
    y = (x - mean) * (rsqrt(var + eps) * scale) + bias, returned in
    `out_dtype` (the compute dtype; None keeps the statistics' dtype)."""

    def __init__(self, c: int, eps: float = 1e-6, out_dtype: torch.dtype = None) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, enabled=False):
            xf = x.to(torch.promote_types(x.dtype, self.weight.dtype))
            mu = xf.mean(dim=-1, keepdim=True)
            var = ((xf * xf).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
            y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y if self.out_dtype is None else y.to(self.out_dtype)


class FlaxSelfAttention(nn.Module):
    """Flax's MultiHeadDotProductAttention(num_heads)(y, y): per-head q/k/v
    projections, the query divided by sqrt(head_dim), softmax over the keys
    in the compute dtype, the heads' outputs through one dense layer."""

    def __init__(self, c: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(c, c)
        self.key = nn.Linear(c, c)
        self.value = nn.Linear(c, c)
        self.out = nn.Linear(c, c)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        b, w, c = y.shape
        hd = c // self.num_heads
        q = self.query(y).view(b, w, self.num_heads, hd)
        k = self.key(y).view(b, w, self.num_heads, hd)
        v = self.value(y).view(b, w, self.num_heads, hd)
        q = q / math.sqrt(hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        with torch.autocast(y.device.type, enabled=False):
            attn = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.out(ctx.reshape(b, w, c))


class TransformerBlock(nn.Module):
    """Pre-LN transformer block over the width axis (depth_net.py:37)."""

    def __init__(self, c: int, num_heads: int = 8, mlp_ratio: int = 4, out_dtype: torch.dtype = None) -> None:
        super().__init__()
        self.ln1 = FlaxLayerNorm(c, out_dtype=out_dtype)
        self.attn = FlaxSelfAttention(c, num_heads)
        self.ln2 = FlaxLayerNorm(c, out_dtype=out_dtype)
        self.mlp1 = nn.Linear(c, c * mlp_ratio)
        self.mlp2 = nn.Linear(c * mlp_ratio, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp2(F.gelu(self.mlp1(self.ln2(x)), approximate="tanh"))


class PanoDepthNet(nn.Module):
    """HoHoNet-style monocular depth for equirectangular panos.

    Called with (B, H, W, 3) RGB in [0, 1]; returns (B, H, W) depth in
    meters (positive, by softplus). `input_hw[0]` sizes the decoder (each
    column expands to H x 32 values); W must be a multiple of 32.
    """

    def __init__(
        self,
        num_layers: int = 50,
        embed_dim: int = 512,
        num_blocks: int = 4,
        compute_dtype: str = "bfloat16",
        input_hw: Tuple[int, int] = (PANO_H, PANO_W),
    ) -> None:
        super().__init__()
        self.num_layers = num_layers
        self.embed_dim = embed_dim
        self.num_blocks = num_blocks
        self.compute_dtype = _DTYPES[compute_dtype]
        self.input_hw = tuple(input_hw)
        bf16 = torch.bfloat16 if self.compute_dtype == torch.bfloat16 else None
        self.trunk = ResNetFeatures(num_layers)
        self.seq_proj = nn.Linear(2 * get_resnet_feature_dim(num_layers), embed_dim)
        self.pos_proj = nn.Linear(2, embed_dim)
        self.blocks = nn.ModuleList([TransformerBlock(embed_dim, out_dtype=bf16) for _ in range(num_blocks)])
        self.norm = FlaxLayerNorm(embed_dim, out_dtype=bf16)
        self.dense_decode = nn.Linear(embed_dim, self.input_hw[0] * TRUNK_STRIDE)
        self.refine1 = nn.Conv2d(1, REFINE_CHANNELS, 5, 1, 2)
        self.refine2 = nn.Conv2d(REFINE_CHANNELS, 1, 3, 1, 1)

    def config(self) -> dict:
        return {"num_layers": self.num_layers, "embed_dim": self.embed_dim, "num_blocks": self.num_blocks,
                "compute_dtype": "bfloat16" if self.compute_dtype == torch.bfloat16 else "float32",
                "input_hw": list(self.input_hw)}

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        b, in_h, in_w = rgb.shape[:3]
        pdtype = self.refine2.weight.dtype
        x = rgb.permute(0, 3, 1, 2).to(pdtype)
        use_bf16 = self.compute_dtype == torch.bfloat16
        with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=use_bf16):
            feats = self.trunk(x)  # (B, C, H/32, W/32)
            fw = feats.shape[3]
            col = torch.cat([feats.amax(dim=2), feats.mean(dim=2)], dim=1).transpose(1, 2)  # (B, fw, 2C)
            seq = self.seq_proj(col)
            # Horizontal (circular) position term: the pano wraps.
            pos = torch.arange(fw, device=x.device, dtype=pdtype) / fw * 2 * math.pi
            pe = torch.stack([torch.sin(pos), torch.cos(pos)], dim=-1)
            seq = seq + self.pos_proj(pe)[None]
            for block in self.blocks:
                seq = block(seq)
            seq = self.norm(seq)
            # Column-to-dense decoder: each feature becomes an (in_h, up_w) tile.
            up_w = in_w // fw
            out = self.dense_decode(seq).reshape(b, fw, in_h, up_w)
            out = out.permute(0, 2, 1, 3).reshape(b, 1, in_h, fw * up_w)
            out = F.relu(self.refine1(out))
        with torch.autocast(x.device.type, enabled=False):
            out = self.refine2(out.to(pdtype))[:, 0]
            return torch.logaddexp(out, torch.zeros_like(out))


@torch.no_grad()
def init_flax_style(model: PanoDepthNet, gen: torch.Generator) -> PanoDepthNet:
    """Re-initialize `model` as salve_tpu's Flax PanoDepthNet initializes,
    drawing from `gen` in module order: every conv and dense kernel LeCun
    normal (Flax's default; attention's kernels too, fan_in = the embed
    width), every bias 0, layer norms 1 / 0, batch norms as
    `early_fusion.init_flax_style` sets them (the last scale of each
    residual branch 0). Returns the model."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            _lecun_normal_(m.weight, m.weight[0].numel(), gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, FlaxLayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for m in model.modules():
        if isinstance(m, BasicBlock):
            m.bn2.weight.zero_()
        elif isinstance(m, Bottleneck):
            m.bn3.weight.zero_()
    return model


# ---------------------------------------------------------------------------
# Training-data synthesis: metric depth from layout geometry.
# ---------------------------------------------------------------------------


def synthesize_depth_from_layout(
    room_vertices: np.ndarray,
    camera_height_m: float,
    ceiling_height_m: float,
    h: int = PANO_H,
    w: int = PANO_W,
) -> np.ndarray:
    """Ray-cast a room layout into a dense (h, w) float32 metric depth map
    (rendering/synthetic.py:raycast_layout): walls are vertical prisms over
    the floor polygon, the floor at -camera_height_m, the ceiling at
    ceiling_height_m - camera_height_m."""
    from salve_tpu_torch.rendering.synthetic import raycast_layout

    return raycast_layout(
        np.asarray(room_vertices, dtype=np.float64),
        camera_height_m=camera_height_m,
        ceiling_height_m=ceiling_height_m,
        h=h,
        w=w,
    )["depth"]


# ---------------------------------------------------------------------------
# Depth producers for depth/cache.py.
# ---------------------------------------------------------------------------


def make_depth_provider(model: PanoDepthNet) -> Callable[[np.ndarray], np.ndarray]:
    """Wrap a PanoDepthNet (on its device, eval mode) as a depth producer:
    (H, W, 3) float RGB in [0, 1] -> (H, W) float32 meters."""
    model = model.eval()
    dev = model.refine2.weight.device

    @torch.no_grad()
    def provider(rgb: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(rgb, dtype=np.float32)).to(dev)
        return model(x[None])[0].float().cpu().numpy()

    return provider


def load_depth_provider(ckpt_fpath: str, num_layers: int = 50, device: DeviceLike = None):
    """A trained PanoDepthNet checkpoint as a depth producer on `device`
    (None: the card). Reads the port's `.pt` (`training/depth.py:
    save_depth_checkpoint`) or salve_tpu's flax msgpack of {"params",
    "batch_stats"} (`cli/train_depth.py`), whose shape gives the width,
    the blocks and the decoder's height; `num_layers` names its trunk."""
    from salve_tpu_torch.models import weights

    dev = resolve_device(device)
    with open(ckpt_fpath, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":  # torch.save's zip container
        payload = torch.load(ckpt_fpath, map_location="cpu", weights_only=True)
        model = PanoDepthNet(**payload["config"])
        model.load_state_dict(payload["model"], strict=True)
    else:
        from salve_tpu_torch.training.flax_checkpoint import read_flax_msgpack

        with open(ckpt_fpath, "rb") as f:
            tree = read_flax_msgpack(f.read())
        sd, config = weights.depth_net_state_dict_from_flax(tree["params"], tree["batch_stats"], num_layers)
        model = PanoDepthNet(**config)
        model.load_state_dict(sd, strict=True)
    return make_depth_provider(model.to(dev))
