"""The verifier's FLOPs from the published architecture, and the kernels'
bytes against PERF.md's bound column."""

import pytest
import torch

from benchmark import flops, rooflines

H100 = "NVIDIA H100 80GB HBM3"


def test_resnet_counts_match_the_published_totals():
    # torchvision's published multiply-adds at 224^2: ResNet-50 4.09 G, ResNet-152 11.51 G
    # (He et al. 2016, Table 1: 3.8 and 11.3 G, counted without the projection shortcuts' share).
    for layers, gmac in ((50, 4.09), (152, 11.51)):
        macs = flops.forward_macs({"num_layers": layers, "n_images": 1, "num_classes": 1000}, 224)
        assert macs / 1e9 == pytest.approx(gmac, abs=0.005)


def test_the_early_fusion_stem_adds_its_channels():
    one = flops.forward_macs({"num_layers": 152, "n_images": 1, "num_classes": 2}, 224)
    four = flops.forward_macs({"num_layers": 152, "n_images": 4, "num_classes": 2}, 224)
    assert four - one == 9 * 7 * 7 * 64 * 112 * 112  # 0.354 GMAC
    assert four / 1e9 == pytest.approx(11.51 + 0.354, abs=0.006)


def test_a_train_step_counts_three_forwards():
    arch = {"num_layers": 152, "n_images": 4, "num_classes": 2}
    # The count by forward hooks on the port's modules (chip_smoke.py): 18.226 TFLOP a step at batch 256.
    assert 3 * flops.forward_flops(arch, 224) * 256 / 1e12 == pytest.approx(18.226, abs=0.001)


@pytest.mark.parametrize("b,n,side,bound_ms", [(4, 180_224, 1001, 0.0067), (4, 180_224, 501, 0.0031),
                                               (32, 180_224, 501, 0.0251), (16, 180_224, 501, 0.0125),
                                               (1, 360_448, 501, 0.0013)])
def test_b1_bound(b, n, side, bound_ms):
    s = rooflines.least_seconds(rooflines.splat_bytes(b, n, side * side), 0, H100)
    assert s * 1e3 == pytest.approx(bound_ms, abs=5e-5)


@pytest.mark.parametrize("b,side,bound_ms", [(4, 1001, 0.0311), (32, 501, 0.0623), (16, 501, 0.0312),
                                             (1, 501, 0.0019)])
def test_b2_bound(b, side, bound_ms):
    s = rooflines.least_seconds(rooflines.fill_bytes(b, side, side), rooflines.fill_ops(b, side, side), H100)
    assert s * 1e3 == pytest.approx(bound_ms, abs=5e-5)


def test_b3_bound():
    # PERF.md: one pair launch, 2 banks x 32 rows of 1001^2 -> 2 x 32 x 501^2 x 3: 0.0337 ms, its
    # hypotheses' outputs all landing in the extended banks; the outputs alone bound it from below.
    d, x3, y2 = 501, 709, 1002
    every = rooflines.least_seconds(rooflines.warp_bytes(32, d, x3, y2, 2, 2 * 32 * d * d), 0, H100) * 1e3
    none = rooflines.least_seconds(rooflines.warp_bytes(32, d, x3, y2, 2, 0), 0, H100) * 1e3
    assert every == pytest.approx(0.0337, abs=5e-5)
    assert none < every


def test_warp_reads_of_the_identity_warp_cover_every_output():
    # Identity rotation and no translation: every output reads the bank.
    b, d, side = 2, 11, 21
    x3 = d + 5
    y2 = d + 8
    row0 = torch.full((b,), (side - d) // 2, dtype=torch.int32)
    starts1 = torch.full((b, y2), (side - d) // 2, dtype=torch.int32)
    starts2 = torch.zeros((b, x3), dtype=torch.int32)
    starts3 = torch.zeros((b, d), dtype=torch.int32)
    assert rooflines.warp_reads(row0, starts1, starts2, starts3, d, x3, y2, side) == b * d * d
    # Shifted wholly off the source: nothing is read.
    assert rooflines.warp_reads(row0 + side, starts1, starts2, starts3, d, x3, y2, side) == 0


def test_unknown_cards_have_no_peak():
    assert rooflines.least_seconds(1.0, 1.0, "some other card") is None
