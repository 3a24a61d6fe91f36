"""Plain float32 HoHoNet monocular depth, written from the published description.

HoHoNet (Sun, Sun, Chen, "HoHoNet: 360 Indoor Holistic Understanding with
Latent Horizontal Features", CVPR 2021), configuration
`mp3d_depth/HOHO_depth_dct_efficienthc_TransEn1_hardnet`:

* the HarDNet-68 trunk (Chao et al., ICCV 2019): a stem of two 3x3 conv
  layers (the first at stride 2) and a 3x3 max pool at stride 2, then five
  harmonic dense blocks of (8, 16, 16, 16, 4) layers with growth rates
  (14, 16, 20, 40, 160) and multiplier 1.7, each followed by a 1x1
  transition to (128, 256, 320, 640, 1024) channels and, after blocks 0, 2
  and 3, a 2x2 max pool. A conv layer is conv (no bias), batch norm, ReLU6.
  Layer L of a block reads the concatenation of layers L - 2^i for every
  2^i dividing L (layer 0 is the block's input); its width is the growth
  rate times 1.7^(links - 1), rounded to even; the block puts out the
  concatenation of its odd layers and its last.
* "efficienthc": the trunk tapped at strides 4, 8, 16 and 32 (after the
  transitions of blocks 0, 2, 3 and 4); each tap's height halved four
  times by 3x3 conv layers at stride (2, 1) with batch norm and ReLU
  (channels c -> c/2 -> c/2 -> c/4 -> c/8), flattened to one feature
  vector a column, its width resampled linearly to W/4; the four
  concatenated, a 1x1 conv to 256, batch norm, ReLU.
* "TransEn1": a learned position embedding over the W/4 columns and one
  post-LN transformer encoder layer (8 heads, FFN 2048, ReLU), as
  torch.nn.TransformerEncoderLayer computes it in eval.
* "depth_dct": a 1x1 conv to 64 coefficients a column, the orthonormal
  DCT-III (inverse DCT) to a 512-high column, the width resampled x4.

Departures, each because the released `ep60.pth` is not in the repository
and the layer plan is the one the program reconstructs, which this file
has to agree with to be compared with it:
* the flattened column vector orders its features (height, channel) with
  the channel fastest;
* no input normalisation: the RGB in [0, 1] enters the stem as it is;
* the width resampling is linear with align_corners=False
  (F.interpolate), the layer norms' epsilon 1e-5, the attention's query
  scaled by 1/sqrt(head size) before the scores.

It takes a state dict in HoHoNet's `.pth` key layout (`state_shapes`), runs
in float32 under `fp32_products` (TF32 off in cuDNN and cuBLAS, checked),
and imports nothing of the program. `precision` names the controls: "tf32"
and "bf16" round every conv and matrix product's operands to TF32's 10 or
bfloat16's 7 bits of mantissa (to nearest, ties to even) before the float32
product, as the tensor cores take them in those formats.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.model import fp32_products

FIRST_CH = (32, 64)
CH_LIST = (128, 256, 320, 640, 1024)
GROWTH = (14, 16, 20, 40, 160)
GRMUL = 1.7
N_LAYERS = (8, 16, 16, 16, 4)
POOL_AFTER = (True, False, True, True, False)
TAPS = (0, 2, 3, 4)
TAP_STRIDES = (4, 8, 16, 32)
EMB = 256
HEADS = 8
FFN = 2048
DCT = 64
WIDTH_DOWN = 4
BN_EPS = 1e-5
LN_EPS = 1e-5
PANO_HW = (512, 1024)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


ROUNDING = {"fp32": None, "tf32": _tf32, "bf16": lambda x: x.to(torch.bfloat16).to(torch.float32)}


def block_plan(n_layers: int, growth: int, cin: int) -> Tuple[List[List[int]], List[int], int]:
    """A harmonic dense block's links (layer indices, 0 the input), each
    layer's width, and the block's output width."""
    widths = [cin]
    links = []
    for layer in range(1, n_layers + 1):
        link = [layer - 2**i for i in range(10) if layer % 2**i == 0]
        ch = growth * GRMUL ** (len(link) - 1)
        widths.append(int(int(ch + 1) / 2) * 2)
        links.append(link)
    out = sum(widths[i] for i in range(1, n_layers + 1) if i % 2 == 1 or i == n_layers)
    return links, widths[1:], out


def _conv_layer_shapes(name: str, cin: int, cout: int, k: int) -> Dict[str, tuple]:
    return {f"{name}.conv.weight": (cout, cin, k, k), **_bn_shapes(f"{name}.norm", cout)}


def _bn_shapes(name: str, c: int) -> Dict[str, tuple]:
    return {f"{name}.weight": (c,), f"{name}.bias": (c,), f"{name}.running_mean": (c,),
            f"{name}.running_var": (c,), f"{name}.num_batches_tracked": ()}


def _compressed_h(h: int) -> int:
    for _ in range(4):
        h = (h + 1) // 2
    return h


def state_shapes(input_hw: Tuple[int, int] = PANO_HW) -> Dict[str, tuple]:
    """Every tensor of the `.pth` state dict at `input_hw`, in order."""
    s: Dict[str, tuple] = {}
    s.update(_conv_layer_shapes("backbone.base_0", 3, FIRST_CH[0], 3))
    s.update(_conv_layer_shapes("backbone.base_1", FIRST_CH[0], FIRST_CH[1], 3))
    ch = FIRST_CH[1]
    for i in range(5):
        links, widths, out = block_plan(N_LAYERS[i], GROWTH[i], ch)
        ins = [ch] + widths
        for j, (link, w) in enumerate(zip(links, widths)):
            s.update(_conv_layer_shapes(f"backbone.block_{i}.layers.{j}", sum(ins[k] for k in link), w, 3))
        s.update(_conv_layer_shapes(f"backbone.trans_{i}", out, CH_LIST[i], 1))
        ch = CH_LIST[i]
    total = 0
    for t, (i, stride) in enumerate(zip(TAPS, TAP_STRIDES)):
        c = CH_LIST[i]
        prev = c
        for j, w in enumerate((c // 2, c // 2, c // 4, c // 8)):
            s.update(_conv_layer_shapes(f"decode.ghc_{t}.layer_{j}", prev, w, 3))
            prev = w
        total += (c // 8) * _compressed_h(input_hw[0] // stride)
    s["decode.proj.weight"] = (EMB, total, 1)
    s.update(_bn_shapes("decode.proj_norm", EMB))
    s["refine.pos_embedding"] = (1, input_hw[1] // WIDTH_DOWN, EMB)
    s.update({"refine.attn.in_proj_weight": (3 * EMB, EMB), "refine.attn.in_proj_bias": (3 * EMB,),
              "refine.attn.out_proj.weight": (EMB, EMB), "refine.attn.out_proj.bias": (EMB,),
              "refine.linear1.weight": (FFN, EMB), "refine.linear1.bias": (FFN,),
              "refine.linear2.weight": (EMB, FFN), "refine.linear2.bias": (EMB,),
              "refine.norm1.weight": (EMB,), "refine.norm1.bias": (EMB,),
              "refine.norm2.weight": (EMB,), "refine.norm2.bias": (EMB,),
              "head.coef.weight": (DCT, EMB, 1), "head.coef.bias": (DCT,)})
    return s


def idct_basis(height: int, device) -> torch.Tensor:
    """(DCT, height) float32 orthonormal DCT-III basis, formed in float64."""
    h = torch.arange(height, dtype=torch.float64, device=device) + 0.5
    k = torch.arange(DCT, dtype=torch.float64, device=device)[:, None]
    basis = math.sqrt(2.0 / height) * torch.cos(math.pi * h * k / height)
    basis[0] = 1.0 / math.sqrt(height)
    return basis.to(torch.float32)


class ReferenceHoHoNet:
    """Functional HoHoNet over a float32 state dict built for `input_hw`."""

    def __init__(self, state: Dict[str, torch.Tensor], input_hw: Tuple[int, int] = PANO_HW,
                 precision: str = "fp32") -> None:
        if precision not in ROUNDING:
            raise ValueError(f"unknown precision {precision}")
        self.s = state
        self.input_hw = tuple(input_hw)
        self.round = ROUNDING[precision]

    def _r(self, *xs):
        return xs if self.round is None else tuple(self.round(x) for x in xs)

    def _bn(self, x, name):
        s = self.s
        return F.batch_norm(x, s[f"{name}.running_mean"], s[f"{name}.running_var"], s[f"{name}.weight"],
                            s[f"{name}.bias"], training=False, eps=BN_EPS)

    def _conv_bn(self, x, name, stride=1):
        w = self.s[f"{name}.conv.weight"]
        x, w = self._r(x, w)
        return self._bn(F.conv2d(x, w, None, stride, w.shape[-1] // 2), f"{name}.norm")

    def _linear(self, x, name):
        x, w = self._r(x, self.s[f"{name}.weight"])
        return F.linear(x, w, self.s[f"{name}.bias"])

    def _matmul(self, a, b):
        a, b = self._r(a, b)
        return a @ b

    def trunk(self, x: torch.Tensor) -> List[torch.Tensor]:
        relu6 = lambda t: t.clamp(0.0, 6.0)  # noqa: E731
        x = relu6(self._conv_bn(x, "backbone.base_0", stride=2))
        x = F.max_pool2d(relu6(self._conv_bn(x, "backbone.base_1")), 3, 2, 1)
        taps = []
        for i in range(5):
            links, _, _ = block_plan(N_LAYERS[i], GROWTH[i], x.shape[1])
            layers = [x]
            for j, link in enumerate(links):
                inp = torch.cat([layers[k] for k in link], dim=1)
                layers.append(relu6(self._conv_bn(inp, f"backbone.block_{i}.layers.{j}")))
            n = len(links)
            x = torch.cat([layers[k] for k in range(1, n + 1) if k % 2 == 1 or k == n], dim=1)
            x = relu6(self._conv_bn(x, f"backbone.trans_{i}"))
            if i in TAPS:
                taps.append(x)
            if POOL_AFTER[i]:
                x = F.max_pool2d(x, 2, 2)
        return taps

    def compress(self, taps: List[torch.Tensor]) -> torch.Tensor:
        """(B, EMB, W/4) horizon features."""
        out_w = self.input_hw[1] // WIDTH_DOWN
        cols = []
        for t, f in enumerate(taps):
            for j in range(4):
                f = F.relu(self._conv_bn(f, f"decode.ghc_{t}.layer_{j}", stride=(2, 1)))
            b, c, h, w = f.shape
            col = f.permute(0, 2, 1, 3).reshape(b, h * c, w)  # (height, channel), channel fastest
            cols.append(F.interpolate(col, size=out_w, mode="linear", align_corners=False))
        x, w = self._r(torch.cat(cols, dim=1), self.s["decode.proj.weight"])
        return F.relu(self._bn(F.conv1d(x, w), "decode.proj_norm"))

    def encoder(self, x: torch.Tensor) -> torch.Tensor:
        """(B, W', EMB) -> (B, W', EMB): position embedding and one post-LN layer."""
        s = self.s
        x = x + s["refine.pos_embedding"]
        b, n, e = x.shape
        hd = e // HEADS
        xr, w = self._r(x, s["refine.attn.in_proj_weight"])
        q, k, v = F.linear(xr, w, s["refine.attn.in_proj_bias"]).split(e, dim=-1)
        q, k, v = (t.reshape(b, n, HEADS, hd).transpose(1, 2) for t in (q, k, v))
        attn = torch.softmax(self._matmul(q / math.sqrt(hd), k.transpose(-1, -2)), dim=-1)
        a = self._linear(self._matmul(attn, v).transpose(1, 2).reshape(b, n, e), "refine.attn.out_proj")
        x = F.layer_norm(x + a, (e,), s["refine.norm1.weight"], s["refine.norm1.bias"], LN_EPS)
        y = self._linear(F.relu(self._linear(x, "refine.linear1")), "refine.linear2")
        return F.layer_norm(x + y, (e,), s["refine.norm2.weight"], s["refine.norm2.bias"], LN_EPS)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """(B, EMB, W') -> (B, H, W) depth in meters."""
        h, w = self.input_hw
        xr, wc = self._r(x, self.s["head.coef.weight"])
        coef = F.conv1d(xr, wc, self.s["head.coef.bias"])  # (B, DCT, W')
        basis = idct_basis(h, x.device)
        cols = self._matmul(basis.t(), coef)  # (B, H, W')
        return F.interpolate(cols, size=w, mode="linear", align_corners=False)

    @torch.no_grad()
    def __call__(self, rgb: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) float RGB in [0, 1] at `input_hw` -> (B, H, W) meters."""
        with fp32_products():
            x = self.compress(self.trunk(rgb.permute(0, 3, 1, 2).to(torch.float32)))
            x = self.encoder(x.transpose(1, 2)).transpose(1, 2)
            return self.head(x)


def depth_mm(depth_m: torch.Tensor) -> torch.Tensor:
    """The u16 depth maps' millimetres: round(depth_m * 1000), half to even,
    clipped to [0, 65535], as float32."""
    return torch.clamp(torch.round(depth_m.to(torch.float32) * 1000.0), 0.0, 65535.0)


@torch.no_grad()
def depth_m(state: Dict[str, torch.Tensor], rgbs: torch.Tensor, precision: str = "fp32",
            block: int = 2) -> torch.Tensor:
    """(P, H, W) float32 meters of a floor's (P, H, W, 3) RGB on the state's
    device, `block` panos a forward; (H, W) is the model's input size."""
    net = ReferenceHoHoNet(state, tuple(rgbs.shape[1:3]), precision)
    return torch.cat([net(rgbs[s:s + block]) for s in range(0, rgbs.shape[0], block)])
