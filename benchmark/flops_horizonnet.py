"""Operations of HorizonNet's forward, counted from the published layer plan.

Multiply-adds of every convolution and matrix product of one pano's forward
(reference/horizonnet.py's plan): the ResNet-50 trunk (its stem, the three
convolutions of each bottleneck and each projection shortcut), the four
taps' height compressions, the LSTM (each layer and direction: the input
product and the recurrent product at every column step) and the output
layer; one FLOP is half a multiply-add. Batch norm, the activations, the
LSTM's gate arithmetic, pooling, padding, the width resampling and the
concatenations are left out, as the published counts leave them out. At
512x1024 this is 142.9 GFLOP a pano: the trunk 85.4, the height
compression 51.0, the LSTM 6.4.
"""

from __future__ import annotations

from typing import Dict, Tuple

from benchmark.reference.horizonnet import (HIDDEN, LAYERS, PANO_HW, STEP_COLS, TAP_CHANNELS, TAP_STRIDES,
                                            compression_plan, rnn_input)
from benchmark.reference.model import EXPANSION, STAGE_BLOCKS


def _out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def trunk_macs(input_hw: Tuple[int, int] = PANO_HW) -> int:
    h, w = _out(input_hw[0], 7, 2, 3), _out(input_hw[1], 7, 2, 3)
    macs = h * w * 49 * 3 * 64  # the stem
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)  # the max pool
    cin = 64
    for i, n_blocks in enumerate(STAGE_BLOCKS[50]):
        planes = 64 * 2**i
        cout = planes * EXPANSION
        for j in range(n_blocks):
            stride = 2 if i > 0 and j == 0 else 1
            oh, ow = _out(h, 3, stride, 1), _out(w, 3, stride, 1)
            macs += h * w * cin * planes  # conv1, 1x1 at the block's input size
            macs += oh * ow * 9 * planes * planes  # conv2, 3x3 at the stride
            macs += oh * ow * planes * cout  # conv3, 1x1
            if j == 0:
                macs += oh * ow * cin * cout  # the projection shortcut
            h, w, cin = oh, ow, cout
    return macs


def compression_macs(input_hw: Tuple[int, int] = PANO_HW) -> int:
    macs = 0
    for c, s in zip(TAP_CHANNELS, TAP_STRIDES):
        h, w = input_hw[0] // s, input_hw[1] // s
        for cin, cout in compression_plan(c):
            h = _out(h, 3, 2, 1)
            macs += h * w * 9 * cin * cout
    return macs


def lstm_macs(input_hw: Tuple[int, int] = PANO_HW) -> int:
    steps = input_hw[1] // STEP_COLS
    macs = 0
    for layer in range(LAYERS):
        n_in = rnn_input(input_hw) if layer == 0 else 2 * HIDDEN
        macs += 2 * steps * 4 * HIDDEN * (n_in + HIDDEN)  # two directions
    return macs + steps * 2 * HIDDEN * 3 * STEP_COLS  # the output layer


def forward_macs_by_part(input_hw: Tuple[int, int] = PANO_HW) -> Dict[str, int]:
    return {"trunk": trunk_macs(input_hw), "height_compression": compression_macs(input_hw),
            "lstm": lstm_macs(input_hw)}


def forward_flops(input_hw: Tuple[int, int] = PANO_HW) -> float:
    return 2.0 * sum(forward_macs_by_part(input_hw).values())
