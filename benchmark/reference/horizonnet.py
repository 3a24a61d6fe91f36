"""Plain float32 HorizonNet room layout, written from the published description.

HorizonNet (Sun, Hsiao, Sun and Chen, "HorizonNet: Learning Room Layout with
1D Representation and Pano Stretch Data Augmentation", CVPR 2019), model.py
with `backbone=resnet50` and `use_rnn=True`:

* the input in [0, 1] normalised by ImageNet's mean and std;
* torchvision's ResNet-50 (He et al., 2016; reference/model.py's plan,
  `STAGE_BLOCKS[50]`) without its pool and head, tapped after each of its
  four stages (256/512/1024/2048 channels at strides 4, 8, 16 and 32);
* per tap four blocks of a 3x3 convolution at stride (2, 1) with a bias,
  batch norm and ReLU, channels c -> c/2 -> c/2 -> c/4 -> c/8, the height
  halved (rounded up) each time; the width padded by one column from the
  other end on each side, resampled linearly (align_corners=False) to
  W/4 + 2 factor columns and cropped by factor at each end; flattened
  channel-major to C H' features a column and concatenated;
* a 2-layer bidirectional LSTM of 512 hidden units a direction over the
  W/4 column steps, each step's gates i, f, g, o = split(W_ih x + b_ih +
  W_hh h + b_hh), c = sigmoid(f) c + sigmoid(i) tanh(g), h = sigmoid(o)
  tanh(c); the reverse direction runs over the steps reversed, and layer 2
  reads [forward, reverse];
* a linear layer to 12 outputs a step: corner, ceiling and floor, 4
  columns a step.
Every convolution that pads its width pads it by wrapping (the published
`wrap_lr_pad`; the max pool pads as torchvision's does). The floor boundary
in pixel rows is (bon_floor / pi + 0.5) H - 0.5 (HorizonNet's inference.py).

It takes a state dict in the released `.pth` key layout (`state_shapes`),
runs in float32 under `fp32_products` (TF32 off in cuDNN and cuBLAS,
checked), has no `nn.LSTM`, cuDNN RNN or batched recurrence, and imports
nothing of the program. `precision` names the controls: "tf32" and "bf16"
round every convolution's and matrix product's operands to TF32's 10 or
bfloat16's 7 bits of mantissa before the float32 product
(reference/hohonet.py:ROUNDING). `fault` plants one of two faults:
"no_reverse" (each LSTM layer's reverse direction dropped: zeros in its
place) or "clamped_resample" (the width resample padded by repeating the
edge columns instead of wrapping).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.hohonet import ROUNDING
from benchmark.reference.model import BN_EPS, EXPANSION, STAGE_BLOCKS, fp32_products

PANO_HW = (512, 1024)
TAP_CHANNELS = (256, 512, 1024, 2048)
TAP_STRIDES = (4, 8, 16, 32)
OUT_SCALE = 8
STEP_COLS = 4
HIDDEN = 512
LAYERS = 2
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
FAULTS = ("no_reverse", "clamped_resample")
ENC = "feature_extractor.encoder"


def _bn(name: str, c: int) -> Dict[str, tuple]:
    return {f"{name}.weight": (c,), f"{name}.bias": (c,), f"{name}.running_mean": (c,),
            f"{name}.running_var": (c,), f"{name}.num_batches_tracked": ()}


def compressed_h(h: int) -> int:
    for _ in range(4):
        h = (h + 1) // 2
    return h


def rnn_input(input_hw: Tuple[int, int]) -> int:
    return sum((c // OUT_SCALE) * compressed_h(input_hw[0] // s) for c, s in zip(TAP_CHANNELS, TAP_STRIDES))


def compression_plan(c: int) -> Tuple[Tuple[int, int], ...]:
    """(in, out) channels of a tap's four height-halving blocks."""
    return ((c, c // 2), (c // 2, c // 2), (c // 2, c // 4), (c // 4, c // OUT_SCALE))


def state_shapes(input_hw: Tuple[int, int] = PANO_HW) -> Dict[str, tuple]:
    """Every tensor of the released `.pth` state dict at `input_hw`, in order
    (a convolution that pads its width is the `.1` of its wrap's Sequential)."""
    s: Dict[str, tuple] = {f"{ENC}.conv1.1.weight": (64, 3, 7, 7), **_bn(f"{ENC}.bn1", 64)}
    cin = 64
    for i, n_blocks in enumerate(STAGE_BLOCKS[50]):
        planes = 64 * 2**i
        cout = planes * EXPANSION
        for j in range(n_blocks):
            p = f"{ENC}.layer{i + 1}.{j}"
            s.update({f"{p}.conv1.weight": (planes, cin, 1, 1), **_bn(f"{p}.bn1", planes),
                      f"{p}.conv2.1.weight": (planes, planes, 3, 3), **_bn(f"{p}.bn2", planes),
                      f"{p}.conv3.weight": (cout, planes, 1, 1), **_bn(f"{p}.bn3", cout)})
            if j == 0:
                s.update({f"{p}.downsample.0.weight": (cout, cin, 1, 1), **_bn(f"{p}.downsample.1", cout)})
            cin = cout
    for t, c in enumerate(TAP_CHANNELS):
        for j, (a, b) in enumerate(compression_plan(c)):
            p = f"reduce_height_module.ghc_lst.{t}.layer.{j}.layers"
            s.update({f"{p}.0.1.weight": (b, a, 3, 3), f"{p}.0.1.bias": (b,), **_bn(f"{p}.1", b)})
    for layer in range(LAYERS):
        n_in = rnn_input(input_hw) if layer == 0 else 2 * HIDDEN
        for sfx in ("", "_reverse"):
            s.update({f"bi_rnn.weight_ih_l{layer}{sfx}": (4 * HIDDEN, n_in),
                      f"bi_rnn.weight_hh_l{layer}{sfx}": (4 * HIDDEN, HIDDEN),
                      f"bi_rnn.bias_ih_l{layer}{sfx}": (4 * HIDDEN,), f"bi_rnn.bias_hh_l{layer}{sfx}": (4 * HIDDEN,)})
    s.update({"linear.weight": (3 * STEP_COLS, 2 * HIDDEN), "linear.bias": (3 * STEP_COLS,)})
    return s


class ReferenceHorizonNet:
    """Functional HorizonNet over a float32 state dict built for `input_hw`."""

    def __init__(self, state: Dict[str, torch.Tensor], input_hw: Tuple[int, int] = PANO_HW,
                 precision: str = "fp32", fault: Optional[str] = None) -> None:
        if precision not in ROUNDING:
            raise ValueError(f"unknown precision {precision}")
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault}")
        self.s = state
        self.input_hw = tuple(input_hw)
        self.round = ROUNDING[precision]
        self.fault = fault

    def _r(self, *xs):
        return xs if self.round is None else tuple(self.round(x) for x in xs)

    def _bn(self, x, name):
        s = self.s
        return F.batch_norm(x, s[f"{name}.running_mean"], s[f"{name}.running_var"], s[f"{name}.weight"],
                            s[f"{name}.bias"], training=False, eps=BN_EPS)

    def _conv(self, x, name, stride, pad: int, bias: bool = False):
        """A convolution whose width padding wraps: `pad` columns from the
        other end on each side, its height padded with zeros."""
        w = self.s[f"{name}.weight"]
        if pad:
            x = torch.cat([x[..., -pad:], x, x[..., :pad]], dim=3)
        x, w = self._r(x, w)
        return F.conv2d(x, w, self.s[f"{name}.bias"] if bias else None, stride, (pad, 0))

    def encoder(self, x: torch.Tensor):
        """The four stage outputs of the ResNet-50."""
        x = F.relu(self._bn(self._conv(x, f"{ENC}.conv1.1", 2, 3), f"{ENC}.bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        taps = []
        for i, n_blocks in enumerate(STAGE_BLOCKS[50]):
            for j in range(n_blocks):
                p = f"{ENC}.layer{i + 1}.{j}"
                stride = 2 if i > 0 and j == 0 else 1
                y = F.relu(self._bn(self._conv(x, f"{p}.conv1", 1, 0), f"{p}.bn1"))
                y = F.relu(self._bn(self._conv(y, f"{p}.conv2.1", stride, 1), f"{p}.bn2"))
                y = self._bn(self._conv(y, f"{p}.conv3", 1, 0), f"{p}.bn3")
                res = self._bn(self._conv(x, f"{p}.downsample.0", stride, 0), f"{p}.downsample.1") if j == 0 else x
                x = F.relu(res + y)
            taps.append(x)
        return taps

    def resample(self, x: torch.Tensor, out_w: int) -> torch.Tensor:
        """(B, C, H, w) -> (B, C, H, out_w): the edge-padded row resampled
        linearly at the padded output's centres, (k + 0.5) scale - 0.5 with
        scale (w + 2) / (out_w + 2 factor), and cropped by factor each end."""
        w = x.shape[3]
        factor = out_w // w
        if self.fault == "clamped_resample":
            x = torch.cat([x[..., :1], x, x[..., -1:]], dim=3)
        else:
            x = torch.cat([x[..., -1:], x, x[..., :1]], dim=3)
        n = out_w + 2 * factor
        scale = torch.tensor((w + 2) / n, dtype=torch.float32)
        src = ((torch.arange(n, dtype=torch.float32) + 0.5) * scale - 0.5).clamp_min(0.0)[factor:-factor]
        lo = src.floor().long().clamp_max(w + 1)
        hi = (lo + 1).clamp_max(w + 1)
        lam = (src - lo.to(torch.float32)).to(x.device)
        return x[..., lo.to(x.device)] * (1.0 - lam) + x[..., hi.to(x.device)] * lam

    def compress(self, taps) -> torch.Tensor:
        """(W/4, B, features): the column steps' feature vectors."""
        out_w = self.input_hw[1] // STEP_COLS
        cols = []
        for t, x in enumerate(taps):
            for j in range(4):
                p = f"reduce_height_module.ghc_lst.{t}.layer.{j}.layers"
                x = F.relu(self._bn(self._conv(x, f"{p}.0.1", (2, 1), 1, bias=True), f"{p}.1"))
            x = self.resample(x, out_w)
            cols.append(x.reshape(x.shape[0], -1, out_w))  # channel-major: c * H' + h
        return torch.cat(cols, dim=1).permute(2, 0, 1)

    def _direction(self, x: torch.Tensor, sfx: str, reverse: bool) -> torch.Tensor:
        s = self.s
        xi, wi = self._r(x, s[f"bi_rnn.weight_ih_{sfx}"])
        xw = xi @ wi.t() + s[f"bi_rnn.bias_ih_{sfx}"]  # (T, B, 4 HIDDEN)
        w_hh, b_hh = s[f"bi_rnn.weight_hh_{sfx}"], s[f"bi_rnn.bias_hh_{sfx}"]
        h = x.new_zeros(x.shape[1], HIDDEN)
        c = x.new_zeros(x.shape[1], HIDDEN)
        out = [None] * x.shape[0]
        for t in (reversed(range(x.shape[0])) if reverse else range(x.shape[0])):
            hr, wr = self._r(h, w_hh)
            i, f, g, o = (xw[t] + (hr @ wr.t() + b_hh)).split(HIDDEN, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out[t] = h
        return torch.stack(out)

    def lstm(self, x: torch.Tensor) -> torch.Tensor:
        """(T, B, features) -> (T, B, 2 HIDDEN)."""
        for layer in range(LAYERS):
            fwd = self._direction(x, f"l{layer}", False)
            rev = torch.zeros_like(fwd) if self.fault == "no_reverse" else self._direction(x, f"l{layer}_reverse", True)
            x = torch.cat([fwd, rev], dim=-1)
        return x

    @torch.no_grad()
    def __call__(self, rgb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) float RGB in [0, 1] at `input_hw` -> (bon (B, 2, W),
        cor (B, 1, W))."""
        with fp32_products():
            x = rgb.permute(0, 3, 1, 2).to(torch.float32)
            mean = torch.tensor(MEAN, device=x.device)[None, :, None, None]
            std = torch.tensor(STD, device=x.device)[None, :, None, None]
            y = self.lstm(self.compress(self.encoder((x - mean) / std)))
            yr, w = self._r(y, self.s["linear.weight"])
            out = yr @ w.t() + self.s["linear.bias"]  # (T, B, 12)
            t, b = out.shape[:2]
            out = out.reshape(t, b, 3, STEP_COLS).permute(1, 2, 0, 3).reshape(b, 3, t * STEP_COLS)
            return out[:, 1:], out[:, :1]


def floor_rows(bon: torch.Tensor, height: int) -> torch.Tensor:
    """The floor boundary in pixel rows: (bon_floor / pi + 0.5) height - 0.5."""
    return (bon[:, 1] / math.pi + 0.5) * height - 0.5


@torch.no_grad()
def boundary_rows(state: Dict[str, torch.Tensor], rgbs: torch.Tensor, precision: str = "fp32",
                  fault: Optional[str] = None, block: int = 2) -> torch.Tensor:
    """(P, W) float32 floor boundary rows of a floor's (P, H, W, 3) RGB on
    the state's device, `block` panos a forward; (H, W) is the model's input
    size."""
    net = ReferenceHorizonNet(state, tuple(rgbs.shape[1:3]), precision, fault)
    h = rgbs.shape[1]
    return torch.cat([floor_rows(net(rgbs[s:s + block])[0], h) for s in range(0, rgbs.shape[0], block)])
