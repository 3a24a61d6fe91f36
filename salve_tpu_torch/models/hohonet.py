"""HoHoNet monocular depth in plain torch (port of salve_tpu/models/hohonet.py).

The architecture of "HOHO_depth_dct_efficienthc_TransEn1_hardnet", as
salve_tpu reconstructs it (NCHW here):

  rgb (B, 3, 512, 1024)
    -> HarDNet-68 features at strides 4/8/16/32 (channels 128/320/640/1024)
    -> per-scale height compression (4 stride-(2,1) conv blocks, height/16)
       flattened to channels, widths linearly resampled to W/4, concat
    -> 1x1 conv to 256 + batch norm + ReLU               ("efficienthc")
    -> learned position embedding + one post-LN transformer encoder layer
       (8 heads, FFN 2048)                                ("TransEn1")
    -> 1x1 conv to 64 DCT coefficients a column, inverse DCT-III to a
       512-high column, width resampled x4                ("depth_dct")
    -> depth (B, 512, 1024) in meters

The module names are the torch key layout that salve_tpu's
`convert_hohonet_state_dict` (salve_tpu/models/hohonet.py:406) consumes:
`backbone.block_{i}.layers.{j}.conv.weight`, `decode.proj.weight` as a
Conv1d (out, in, 1), `refine.attn.in_proj_weight` and so on. So a HoHoNet
`.pth` loads with `load_state_dict(strict=True)` and needs no converter.

Numerics follow salve_tpu's Flax model: ReLU6 is min(relu(x), 6); the
attention divides the scores (not the query) by sqrt(head_dim); the two
LayerNorms are Flax's with epsilon 1e-5; the width resampling is
salve_tpu's `_interp_width_linear`. Inference only: batch norm reads its
running statistics.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.models.depth_net import FlaxLayerNorm

HARDNET68 = {
    "first_ch": (32, 64),
    "ch_list": (128, 256, 320, 640, 1024),
    "growth_rate": (14, 16, 20, 40, 160),
    "grmul": 1.7,
    "n_layers": (8, 16, 16, 16, 4),
    "down_samp": (1, 0, 1, 1, 0),
}

# Strides of the four feature taps the height compression reads.
FEATURE_STRIDES = (4, 8, 16, 32)
FEATURE_TAPS = (0, 2, 3, 4)
EMB_DIM = 256
N_HEADS = 8
FFN_DIM = 2048
N_DCT_COMPONENTS = 64
INPUT_HW = (512, 1024)
HC_DOWN = 8          # channel divisor in the height compression
WIDTH_DOWN = 4       # horizon-feature width = W / WIDTH_DOWN


def _hard_block_plan(
    in_channels: int, growth_rate: int, grmul: float, n_layers: int
) -> Tuple[List[List[int]], List[int], List[int], int]:
    """Static link/channel plan of a HarDBlock.

    Layer L (1-based) reads the concat of layers L-1, L-2, L-4, ... (those
    with L % 2**i == 0), its width is growth_rate * grmul**(#links-1)
    rounded to even. Block output concatenates the input-excluded odd
    feature maps + the last one.
    """
    out_ch = {0: in_channels}
    links: List[List[int]] = []
    layer_out: List[int] = []
    layer_in: List[int] = []
    for layer in range(1, n_layers + 1):
        ch = float(growth_rate)
        link = []
        for i in range(10):
            dv = 2 ** i
            if layer % dv == 0:
                link.append(layer - dv)
                if i > 0:
                    ch *= grmul
        ch = int(int(ch + 1) / 2) * 2
        out_ch[layer] = ch
        links.append(link)
        layer_out.append(ch)
        layer_in.append(sum(out_ch[i] for i in link))
    block_out = sum(
        out_ch[i]
        for i in range(1, n_layers + 1)
        if (i % 2 == 1) or (i == n_layers)
    )
    return links, layer_out, layer_in, block_out


class ConvLayer(nn.Module):
    """HarDNet conv block: conv (no bias) + batch norm + ReLU6."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1) -> None:
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False)
        self.norm = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp_max(F.relu(self.norm(self.conv(x))), 6.0)


class HarDBlock(nn.Module):
    """Harmonic dense block (log-sparse skip links)."""

    def __init__(self, in_ch: int, growth_rate: int, grmul: float, n_layers: int) -> None:
        super().__init__()
        self.links, layer_out, layer_in, self.out_ch = _hard_block_plan(in_ch, growth_rate, grmul, n_layers)
        self.n_layers = n_layers
        self.layers = nn.ModuleList([ConvLayer(layer_in[j], layer_out[j]) for j in range(n_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for layer in range(1, self.n_layers + 1):
            tin = [feats[i] for i in self.links[layer - 1]]
            inp = torch.cat(tin, dim=1) if len(tin) > 1 else tin[0]
            feats.append(self.layers[layer - 1](inp))
        keep = [feats[i] for i in range(1, self.n_layers + 1) if (i % 2 == 1) or (i == self.n_layers)]
        return torch.cat(keep, dim=1)


class HarDNetFeatures(nn.Module):
    """HarDNet-68 trunk returning the stride-4/8/16/32 feature maps."""

    def __init__(self) -> None:
        super().__init__()
        cfg = HARDNET68
        self.base_0 = ConvLayer(3, cfg["first_ch"][0], stride=2)
        self.base_1 = ConvLayer(cfg["first_ch"][0], cfg["first_ch"][1])
        ch = cfg["first_ch"][1]
        for i in range(5):
            blk = HarDBlock(ch, cfg["growth_rate"][i], cfg["grmul"], cfg["n_layers"][i])
            self.add_module(f"block_{i}", blk)
            self.add_module(f"trans_{i}", ConvLayer(blk.out_ch, cfg["ch_list"][i], kernel=1))
            ch = cfg["ch_list"][i]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.max_pool2d(self.base_1(self.base_0(x)), 3, 2, 1)  # stride 4
        feats = []
        for i in range(5):
            x = getattr(self, f"trans_{i}")(getattr(self, f"block_{i}")(x))
            if i in FEATURE_TAPS:
                feats.append(x)
            if HARDNET68["down_samp"][i] == 1:
                x = F.max_pool2d(x, 2, 2)
        return feats


class ConvCompressH(nn.Module):
    """Height-halving conv: 3x3 stride (2, 1) + batch norm + ReLU.

    HorizonNet's block, which HoHoNet inherited: HorizonNet's conv carries a
    bias (`bias=True`, models/horizonnet.py), HoHoNet's none."""

    def __init__(self, cin: int, cout: int, bias: bool = False) -> None:
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, (2, 1), 1, bias=bias)
        self.norm = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.norm(self.conv(x)))


class GlobalHeightConv(nn.Module):
    """Four ConvCompressH blocks: height /16, channels in -> in/2 -> in/2 -> in/4 -> out."""

    def __init__(self, in_ch: int, out_ch: int, bias: bool = False) -> None:
        super().__init__()
        prev = in_ch
        for j, w in enumerate([in_ch // 2, in_ch // 2, in_ch // 4, out_ch]):
            self.add_module(f"layer_{j}", ConvCompressH(prev, w, bias))
            prev = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j in range(4):
            x = getattr(self, f"layer_{j}")(x)
        return x


def _interp_width_linear(x: torch.Tensor, out_w: int) -> torch.Tensor:
    """Linear resample of (..., W, C) along W, align_corners=False, in
    salve_tpu's arithmetic (hohonet.py:244): positions
    (i + 0.5) * (in_w / out_w) - 0.5 in float32, lo/hi clipped to the
    row, frac clipped to [0, 1], xl + (xh - xl) * frac."""
    in_w = x.shape[-2]
    if in_w == out_w:
        return x
    pos = (torch.arange(out_w, device=x.device, dtype=torch.float32) + 0.5) * (in_w / out_w) - 0.5
    lo_f = torch.clamp(torch.floor(pos), 0, in_w - 1)
    lo = lo_f.long()
    hi = torch.clamp(lo + 1, 0, in_w - 1)
    frac = torch.clamp(pos - lo_f, 0.0, 1.0).to(x.dtype)
    xl = x.index_select(-2, lo)
    xh = x.index_select(-2, hi)
    return xl + (xh - xl) * frac[:, None]


def h_after_compression(h: int) -> int:
    """Height after GlobalHeightConv's four ceil-halvings."""
    for _ in range(4):
        h = (h + 1) // 2
    return h


class EfficientHeightCompression(nn.Module):
    """Per-scale height compression -> common-width concat -> EMB_DIM."""

    def __init__(self, input_hw: Tuple[int, int] = INPUT_HW) -> None:
        super().__init__()
        feat_chs = [HARDNET68["ch_list"][i] for i in FEATURE_TAPS]
        self.out_w = input_hw[1] // WIDTH_DOWN
        total = 0
        for i, c in enumerate(feat_chs):
            self.add_module(f"ghc_{i}", GlobalHeightConv(c, c // HC_DOWN))
            total += (c // HC_DOWN) * h_after_compression(input_hw[0] // FEATURE_STRIDES[i])
        self.proj = nn.Conv1d(total, EMB_DIM, 1, bias=False)
        self.proj_norm = nn.BatchNorm1d(EMB_DIM, eps=1e-5)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        """Feature maps (B, C_i, H_i, W_i) -> (B, W/4, EMB_DIM)."""
        columns = []
        for i, f in enumerate(feats):
            g = getattr(self, f"ghc_{i}")(f)  # (B, C, H', W)
            b, c, h, w = g.shape
            # salve_tpu flattens (H', C) with C fastest: (B, W, H' * C).
            col = g.permute(0, 3, 2, 1).reshape(b, w, h * c)
            columns.append(_interp_width_linear(col, self.out_w))
        x = F.linear(torch.cat(columns, dim=-1), self.proj.weight[:, :, 0])  # (B, W', E)
        x = self.proj_norm(x.transpose(1, 2)).transpose(1, 2)
        return F.relu(x)


class PackedSelfAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (a packed (3E, E) in_proj
    and `out_proj`), computed as salve_tpu computes them: the scores divided
    by sqrt(head_dim), explicit matmuls and softmax."""

    def __init__(self, e: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * e, e))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * e))
        self.out_proj = nn.Linear(e, e)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, w, e = x.shape
        hd = e // self.num_heads
        qkv = x @ self.in_proj_weight.t() + self.in_proj_bias
        q, k, v = (t.reshape(b, w, self.num_heads, hd).transpose(1, 2) for t in qkv.split(e, dim=-1))
        attn = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(b, w, e))


class TransEn1(nn.Module):
    """Learned position embedding + one post-LN transformer encoder layer:
    self-attention -> residual -> LN -> FFN(ReLU) -> residual -> LN."""

    def __init__(self, seq_len: int) -> None:
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.randn(1, seq_len, EMB_DIM) * 0.02)
        self.attn = PackedSelfAttention(EMB_DIM, N_HEADS)
        self.linear1 = nn.Linear(EMB_DIM, FFN_DIM)
        self.linear2 = nn.Linear(FFN_DIM, EMB_DIM)
        self.norm1 = FlaxLayerNorm(EMB_DIM, eps=1e-5)
        self.norm2 = FlaxLayerNorm(EMB_DIM, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.pos_embedding
        x = self.norm1(x + self.attn(x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


def _idct3_matrix(n_components: int, height: int) -> np.ndarray:
    """Orthonormal inverse DCT (DCT-III) basis: (n_components, height)."""
    h = np.arange(height)
    basis = np.zeros((n_components, height), dtype=np.float64)
    basis[0] = 1.0 / np.sqrt(height)
    for k in range(1, n_components):
        basis[k] = np.sqrt(2.0 / height) * np.cos(np.pi * (h + 0.5) * k / height)
    return basis.astype(np.float32)


class DCTDepthHead(nn.Module):
    """Per-column DCT coefficients -> dense depth column -> width resample."""

    def __init__(self, height: int = INPUT_HW[0], out_w: int = INPUT_HW[1]) -> None:
        super().__init__()
        self.coef = nn.Conv1d(EMB_DIM, N_DCT_COMPONENTS, 1)
        self.register_buffer("basis", torch.from_numpy(_idct3_matrix(N_DCT_COMPONENTS, height)), persistent=False)
        self.out_w = out_w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, W', E) -> (B, H, W)."""
        coefs = F.linear(x, self.coef.weight[:, :, 0], self.coef.bias)  # (B, W', K)
        cols = coefs @ self.basis.to(coefs.dtype)  # (B, W', H)
        return _interp_width_linear(cols, self.out_w).transpose(1, 2)


class HoHoNetDepth(nn.Module):
    """The whole depth model: (B, H, W, 3) float RGB in [0, 1] -> (B, H, W)
    meters. `input_hw` is the resolution the weights were built for (the
    height compression bakes the input height into the weights' shapes)."""

    def __init__(self, input_hw: Tuple[int, int] = INPUT_HW) -> None:
        super().__init__()
        self.input_hw = tuple(input_hw)
        self.backbone = HarDNetFeatures()
        self.decode = EfficientHeightCompression(self.input_hw)
        self.refine = TransEn1(self.input_hw[1] // WIDTH_DOWN)
        self.head = DCTDepthHead(self.input_hw[0], self.input_hw[1])

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        x = rgb.permute(0, 3, 1, 2).to(self.head.coef.weight.dtype)
        return self.head(self.refine(self.decode(self.backbone(x))))


@torch.no_grad()
def seeded_hohonet(input_hw: Tuple[int, int] = INPUT_HW, seed: int = 0, mean_depth_m: float = 2.5) -> HoHoNetDepth:
    """A HoHoNetDepth with random weights drawn from `seed`, for runs
    without a trained checkpoint: every parameter N(0, 0.05), running means
    N(0, 0.1), running variances U(0.75, 1.25), and the DC coefficient's
    bias raised so the depth centers near `mean_depth_m` (the DCT's first
    basis row is 1 / sqrt(H))."""
    model = HoHoNetDepth(input_hw).eval()
    gen = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    for name, b in model.named_buffers():
        if name.endswith("running_mean"):
            b.copy_(torch.randn(b.shape, generator=gen) * 0.1)
        elif name.endswith("running_var"):
            b.copy_(torch.rand(b.shape, generator=gen) * 0.5 + 0.75)
    model.head.coef.bias[0] += mean_depth_m * math.sqrt(input_hw[0])
    return model


# ---------------------------------------------------------------------------
# jax.image.resize(..., method="linear") as salve_tpu's provider calls it.
# ---------------------------------------------------------------------------


def linear_resize_weights(in_size: int, out_size: int) -> torch.Tensor:
    """(in_size, out_size) float32 weights of jax.image.resize's "linear"
    method along one axis, with its default antialias=True
    (jax/_src/image/scale.py:compute_weight_mat): a triangle kernel widened
    by in/out when downscaling, each output's weights renormalized to sum
    to 1, outputs whose sample falls outside the input zeroed."""
    inv_scale = 1.0 / (out_size / in_size)  # in float64, as JAX takes it from Python floats
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs() / float(kernel_scale)
    weights = torch.clamp_min(1.0 - x.abs(), 0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize_linear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(img, (*out_hw, ...), method="linear") for an
    (H, W) or (H, W, C) float32 tensor (`resize_linear_batch` of one)."""
    return resize_linear_batch(img[None], out_hw)[0]


def resize_linear_batch(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """`resize_linear` of each image of a (B, H, W) or (B, H, W, C) float32
    batch: one weight matrix per resized axis, applied as a matrix product
    along it (an axis of equal size is skipped)."""
    for axis, size in ((1, out_hw[0]), (2, out_hw[1])):
        if x.shape[axis] != size:
            weights = linear_resize_weights(x.shape[axis], size).to(x.device)
            x = torch.movedim(torch.movedim(x, axis, -1) @ weights, -1, axis)
    return x


def load_hohonet_state_dict(ckpt_fpath: str) -> dict:
    """A HoHoNet torch checkpoint's state_dict (a `"state_dict"` key
    unwrapped, as salve_tpu/models/hohonet.py:530-532 does)."""
    sd = torch.load(ckpt_fpath, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def load_hohonet(ckpt_fpath: str, input_hw: Tuple[int, int] = INPUT_HW, device: DeviceLike = None) -> HoHoNetDepth:
    """A HoHoNet `.pth` (ep60.pth of
    mp3d_depth_HOHO_depth_dct_efficienthc_TransEn1_hardnet, or any file in
    its key layout) loaded strictly into a HoHoNetDepth built for
    `input_hw`, in eval mode on `device` (None: the card; raises without
    one before the file is read)."""
    dev = resolve_device(device)
    model = HoHoNetDepth(input_hw)
    model.load_state_dict(load_hohonet_state_dict(ckpt_fpath), strict=True)
    return model.to(dev).eval()


def load_hohonet_depth_provider(ckpt_fpath: str, input_hw: Tuple[int, int] = INPUT_HW, device: DeviceLike = None):
    """`load_hohonet` as a depth producer for the cache (depth/cache.py) on
    `device` (None: the card), in float32: (512, 1024, 3) float RGB in
    [0, 1] -> (512, 1024) float32 meters. `input_hw` is the resolution the
    checkpoint was built for; at another one the pano is resized to it, and
    the depth back to 512x1024, by `resize_linear`
    (salve_tpu/models/hohonet.py:539,544)."""
    model = load_hohonet(ckpt_fpath, input_hw, device)
    dev = model.head.coef.weight.device
    input_hw = tuple(input_hw)

    @torch.no_grad()
    def provider(rgb: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(rgb, dtype=np.float32)).to(dev)
        if tuple(x.shape[:2]) != input_hw:
            x = resize_linear(x, input_hw)
        depth = model(x[None])[0]
        if tuple(depth.shape) != INPUT_HW:
            depth = resize_linear(depth, INPUT_HW)
        return depth.cpu().numpy()

    return provider
