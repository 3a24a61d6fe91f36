"""Operations of HoHoNet's forward, counted from the published layer plan.

Multiply-adds of every convolution and matrix product of one pano's
forward (reference/hohonet.py's plan: the HarDNet-68 trunk, the four
height compressions, the 1x1 projection, the encoder layer with its two
attention products, the DCT head and its inverse transform); one FLOP is
half a multiply-add. Batch norm, the activations, pooling, the
concatenations, the softmax, the layer norms and the width resampling are
left out, as the published counts leave them out. At 512x1024 this is
105.9 GFLOP a pano.
"""

from __future__ import annotations

from typing import Tuple

from benchmark.reference.hohonet import (CH_LIST, DCT, EMB, FFN, FIRST_CH, GROWTH, N_LAYERS, PANO_HW, POOL_AFTER,
                                         TAP_STRIDES, TAPS, WIDTH_DOWN, block_plan)


def forward_macs(input_hw: Tuple[int, int] = PANO_HW) -> int:
    h, w = input_hw
    macs = 0
    # Stem: 3x3 conv at stride 2, 3x3 conv, then a 3x3 max pool at stride 2.
    sh, sw = -(-h // 2), -(-w // 2)
    macs += sh * sw * 9 * (3 * FIRST_CH[0] + FIRST_CH[0] * FIRST_CH[1])
    sh, sw = -(-sh // 2), -(-sw // 2)
    ch = FIRST_CH[1]
    for i in range(5):
        links, widths, out = block_plan(N_LAYERS[i], GROWTH[i], ch)
        ins = [ch] + widths
        macs += sh * sw * 9 * sum(sum(ins[k] for k in link) * wd for link, wd in zip(links, widths))
        macs += sh * sw * out * CH_LIST[i]  # 1x1 transition
        ch = CH_LIST[i]
        if POOL_AFTER[i]:
            sh, sw = sh // 2, sw // 2
    cols = w // WIDTH_DOWN
    total = 0
    for i, stride in zip(TAPS, TAP_STRIDES):
        c = CH_LIST[i]
        th, tw = h // stride, w // stride
        for cin, cout in zip((c, c // 2, c // 2, c // 4), (c // 2, c // 2, c // 4, c // 8)):
            th = -(-th // 2)  # 3x3 at stride (2, 1)
            macs += th * tw * 9 * cin * cout
        total += (c // 8) * th
    macs += cols * total * EMB  # projection to EMB
    macs += cols * EMB * 3 * EMB + 2 * cols * cols * EMB + cols * EMB * EMB  # attention
    macs += 2 * cols * EMB * FFN  # feed-forward
    macs += cols * EMB * DCT + cols * DCT * h  # DCT coefficients and the inverse transform
    return macs


def forward_flops(input_hw: Tuple[int, int] = PANO_HW) -> float:
    return 2.0 * forward_macs(input_hw)
