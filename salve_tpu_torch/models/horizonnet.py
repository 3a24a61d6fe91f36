"""HorizonNet room layout in plain torch (the published `resnet50_rnn` model).

Sun, Hsiao, Sun and Chen, "HorizonNet: Learning Room Layout with 1D
Representation and Pano Stretch Data Augmentation", CVPR 2019;
https://github.com/sunset1995/HorizonNet/blob/master/model.py with
`backbone=resnet50` and `use_rnn=True`, the released `resnet50_rnn` models.
It is the public base of the ModifiedHorizonNet whose floor boundary SALVe
consumes (dataset/mhnet_prediction.py). NCHW:

  rgb (B, 3, 512, 1024) in [0, 1], normalised by ImageNet's mean and std
    -> ResNet-50 (models/resnet.py:ResNetFeatures, no mean pool) tapped
       after layer1 to layer4: 256/512/1024/2048 channels at 128x256,
       64x128, 32x64 and 16x32
    -> per tap a GlobalHeightConv(c, c/8): four ConvCompressH (3x3 conv at
       stride (2, 1) with bias, batch norm, ReLU), channels c -> c/2 -> c/2
       -> c/4 -> c/8 (models/hohonet.py:GlobalHeightConv), the
       height to 8, 4, 2 and 1 rows; the width padded by one column from
       the other end on each side, resampled bilinearly (align_corners
       False) to W/4 + 2 factor columns and cropped by factor at each end;
       reshaped channel-major to (B, C H', W/4) and concatenated: 1024
       features a column step at 512x1024
    -> a 2-layer bidirectional LSTM, 512 hidden a direction, over the W/4
       column steps (dropout 0.5 between the layers: nothing in eval)
    -> Linear(1024, 12), reshaped to (B, 3, W): corner, ceiling and floor,
       4 columns a step
  -> (bon (B, 2, W): the ceiling and floor boundaries in radians, cor
     (B, 1, W): the corner logits), as the published forward returns them.

As the published model does at construction (`wrap_lr_pad`), every
convolution that pads its width pads it by wrapping (the panorama is
periodic in width), so it sits in `nn.Sequential(LRPad(p), conv)`; with the
published module names this makes the state dict the released `.pth`'s key
layout: `feature_extractor.encoder.conv1.1.weight`,
`feature_extractor.encoder.layer1.0.conv2.1.weight`, ...,
`bi_rnn.weight_ih_l0_reverse`, ..., `linear.*`. A released checkpoint loads
with `load_state_dict(strict=True)`.

The height-compression blocks are models/hohonet.py's `GlobalHeightConv`
and `ConvCompressH`, HorizonNet's blocks that HoHoNet inherited, built with
the conv's bias. Their modules keep HoHoNet's names (`layer_{j}.conv`,
`layer_{j}.norm`); `GlobalHeightStage` maps them to the released names
(`layer.{j}.layers.0.1.*` for the wrapped conv, `layer.{j}.layers.1.*` for
the batch norm) in its state dict and back when one is loaded.

`input_hw` is the resolution the weights are built for: the LSTM's input
size is the height compression's output at it, as the published model
reads it off a dummy forward. Inference only: batch norm reads its
running statistics. On the card the model runs in float32 under the port's
numerics policy (device.py: TF32 off), the LSTM as cuDNN's RNN.
"""

from __future__ import annotations

import math
import re
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from salve_tpu_torch.device import DeviceLike, resolve_device
from salve_tpu_torch.models.hohonet import GlobalHeightConv, h_after_compression, load_hohonet_state_dict
from salve_tpu_torch.models.resnet import ResNetFeatures

INPUT_HW = (512, 1024)
BACKBONE_LAYERS = 50  # resnet50
TAP_CHANNELS = (256, 512, 1024, 2048)  # layer1 to layer4 of ResNet-50
TAP_STRIDES = (4, 8, 16, 32)
OUT_SCALE = 8  # channel divisor of the height compression
STEP_COLS = 4  # boundary columns a LSTM step
RNN_HIDDEN = 512
RNN_LAYERS = 2
# The published initialisation of the output layer's bias: corner, ceiling, floor.
LINEAR_BIAS = (-1.0, -0.478, 0.425)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class LRPad(nn.Module):
    """Pad the width by wrapping: the last `padding` columns on the left and
    the first on the right (the published `LR_PAD`)."""

    def __init__(self, padding: int = 1) -> None:
        super().__init__()
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.padding
        return torch.cat([x[..., -p:], x, x[..., :p]], dim=3)


def wrap_lr_pad(net: nn.Module) -> nn.Module:
    """Every Conv2d of `net` that pads its width pads it by wrapping instead
    (the published `wrap_lr_pad`): its width padding moves into an `LRPad`
    before it, the two in an `nn.Sequential` in the conv's place."""
    for name, m in list(net.named_modules()):
        if not isinstance(m, nn.Conv2d) or m.padding[1] == 0:
            continue
        w_pad = int(m.padding[1])
        m.padding = (m.padding[0], 0)
        parent, _, leaf = name.rpartition(".")
        setattr(net.get_submodule(parent) if parent else net, leaf, nn.Sequential(LRPad(w_pad), m))
    return net


def resample_width_wrapped(x: torch.Tensor, out_w: int) -> torch.Tensor:
    """(B, C, H, w) -> (B, C, H, out_w), out_w a multiple of w: one column
    from the other end added on each side, a bilinear resample
    (align_corners=False) to out_w + 2 factor columns, factor cropped at
    each end: a linear resample of the periodic row."""
    if out_w % x.shape[3]:
        raise ValueError(f"{out_w} column steps are no multiple of the feature's {x.shape[3]} columns")
    factor = out_w // x.shape[3]
    x = torch.cat([x[..., -1:], x, x[..., :1]], dim=3)
    x = F.interpolate(x, size=(x.shape[2], out_w + 2 * factor), mode="bilinear", align_corners=False)
    return x[..., factor:-factor]


# The height compression's module names (hohonet.GlobalHeightConv's, the
# conv wrapped by `wrap_lr_pad`) and the released ones, each way.
_RELEASED_NAMES = ((re.compile(r"(ghc_lst\.\d+\.)layer_(\d+)\.conv\."), r"\1layer.\2.layers.0."),
                   (re.compile(r"(ghc_lst\.\d+\.)layer_(\d+)\.norm\."), r"\1layer.\2.layers.1."))
_MODULE_NAMES = ((re.compile(r"(ghc_lst\.\d+\.)layer\.(\d+)\.layers\.0\."), r"\1layer_\2.conv."),
                 (re.compile(r"(ghc_lst\.\d+\.)layer\.(\d+)\.layers\.1\."), r"\1layer_\2.norm."))


def _rename(state: dict, prefix: str, names) -> None:
    """Rename, in place and in order, the keys of `state` under `prefix`."""
    keys = [k for k in state if k.startswith(prefix)]
    for k in keys:
        v = state.pop(k)
        rest = k[len(prefix):]
        for pattern, repl in names:
            rest = pattern.sub(repl, rest, count=1)
        state[prefix + rest] = v


class GlobalHeightStage(nn.Module):
    """The four taps' height compressions (hohonet.GlobalHeightConv(c, c/8)
    with the conv's bias), each resampled by `resample_width_wrapped` and
    concatenated channel-major: (B, sum C H', out_w). Its state dict holds
    the released key names (module docstring)."""

    def __init__(self, channels: Sequence[int]) -> None:
        super().__init__()
        self.ghc_lst = nn.ModuleList([GlobalHeightConv(c, c // OUT_SCALE, bias=True) for c in channels])
        # A module's keys are the last in the state dict when its post hook
        # runs, so renaming them in place keeps the dict's order.
        self.register_state_dict_post_hook(lambda m, state, prefix, meta: _rename(state, prefix, _RELEASED_NAMES))
        self.register_load_state_dict_pre_hook(lambda m, state, prefix, *rest: _rename(state, prefix, _MODULE_NAMES))

    def forward(self, taps: Sequence[torch.Tensor], out_w: int) -> torch.Tensor:
        b = taps[0].shape[0]
        return torch.cat([resample_width_wrapped(f(x), out_w).reshape(b, -1, out_w)
                          for f, x in zip(self.ghc_lst, taps)], dim=1)


class _Encoder(nn.Module):
    """The published `Resnet` wrapper: torchvision's ResNet as `encoder`, its
    four stage outputs."""

    def __init__(self) -> None:
        super().__init__()
        self.encoder = ResNetFeatures(BACKBONE_LAYERS)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.encoder.stages(x)


def rnn_input_size(input_hw: Tuple[int, int]) -> int:
    """Features a column step: each tap's c / OUT_SCALE channels times its
    height after four halvings, summed (1024 at 512x1024)."""
    return sum((c // OUT_SCALE) * h_after_compression(input_hw[0] // s) for c, s in zip(TAP_CHANNELS, TAP_STRIDES))


class HorizonNet(nn.Module):
    """The whole model (module docstring): (B, 3, H, W) RGB in [0, 1] at
    `input_hw` -> (bon (B, 2, W), cor (B, 1, W))."""

    def __init__(self, input_hw: Tuple[int, int] = INPUT_HW) -> None:
        super().__init__()
        self.input_hw = tuple(input_hw)
        self.feature_extractor = _Encoder()
        self.reduce_height_module = GlobalHeightStage(TAP_CHANNELS)
        self.bi_rnn = nn.LSTM(input_size=rnn_input_size(self.input_hw), hidden_size=RNN_HIDDEN,
                              num_layers=RNN_LAYERS, dropout=0.5, batch_first=False, bidirectional=True)
        self.drop_out = nn.Dropout(0.5)
        self.linear = nn.Linear(2 * RNN_HIDDEN, 3 * STEP_COLS)
        with torch.no_grad():
            for k, v in enumerate(LINEAR_BIAS):
                self.linear.bias[k * STEP_COLS : (k + 1) * STEP_COLS] = v
        self.register_buffer("x_mean", torch.tensor(IMAGENET_MEAN)[None, :, None, None], persistent=False)
        self.register_buffer("x_std", torch.tensor(IMAGENET_STD)[None, :, None, None], persistent=False)
        wrap_lr_pad(self)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if tuple(x.shape[2:]) != self.input_hw:
            raise ValueError(f"HorizonNet built for {self.input_hw} got a {tuple(x.shape[2:])} image")
        x = (x[:, :3] - self.x_mean) / self.x_std
        feature = self.reduce_height_module(self.feature_extractor(x), x.shape[3] // STEP_COLS)
        output, _ = self.bi_rnn(feature.permute(2, 0, 1))  # (steps, B, 2 hidden)
        output = self.linear(self.drop_out(output))  # (steps, B, 3 STEP_COLS)
        output = output.view(output.shape[0], output.shape[1], 3, STEP_COLS).permute(1, 2, 0, 3)
        output = output.contiguous().view(output.shape[0], 3, -1)  # (B, 3, W)
        return output[:, 1:], output[:, :1]


def floor_boundary_rows(bon: torch.Tensor, height: int) -> torch.Tensor:
    """The floor boundary of `bon` (B, 2, W) in pixel rows of an image
    `height` high: (bon_floor / pi + 0.5) height - 0.5, HorizonNet's
    inference.py conversion, as SALVe reads it."""
    return (bon[:, 1] / math.pi + 0.5) * height - 0.5


def load_horizonnet(ckpt_fpath: str, input_hw: Tuple[int, int] = INPUT_HW, device: DeviceLike = None) -> HorizonNet:
    """A HorizonNet `.pth` (a released `resnet50_rnn` file, or any in its key
    layout) loaded strictly into a HorizonNet built for `input_hw`, in eval
    mode on `device` (None: the card; raises without one before the file is
    read). The released files hold the state dict under `"state_dict"`,
    beside `"kwargs"` and `"args"`, as HoHoNet's do."""
    dev = resolve_device(device)
    model = HorizonNet(input_hw)
    model.load_state_dict(load_hohonet_state_dict(ckpt_fpath), strict=True)
    return model.to(dev).eval()
