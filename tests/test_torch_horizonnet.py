"""HorizonNet (models/horizonnet.py) against the benchmark's plain reference
(benchmark/reference/horizonnet.py), on the CPU at small input sizes with
weights drawn from a seed (benchmark/horizonnet_weights.py).

Tolerance: 1e-5 in the boundary and corner outputs (radians and logits):
both sides are float32 and differ only in the order of their sums (cuDNN-free
convolutions and the LSTM's gates written out in the reference), which reads
2.4e-7 here; the reference with its products' operands rounded to TF32 reads
some 3e-4, and each planted fault (the LSTM's reverse direction dropped, the
width resample padded by its edge instead of wrapping) 1e-2 or more.
"""

import numpy as np
import pytest
import torch

from benchmark.horizonnet_weights import make_state_dict
from benchmark.reference import horizonnet as ref
from salve_tpu_torch.models import horizonnet as hn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOLERANCE = 1e-5
SIZES = [(64, 128), (32, 256)]


def seeded(hw, seed=5):
    model = hn.HorizonNet(hw).eval()
    model.load_state_dict(make_state_dict(seed, "cpu", hw), strict=True)
    return model


def rgb(hw, n=2, seed=1):
    return torch.rand(n, *hw, 3, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_the_port_agrees_with_the_plain_reference(hw):
    model, x = seeded(hw), rgb(hw)
    with torch.no_grad():
        bon, cor = model(x.permute(0, 3, 1, 2))
    want_bon, want_cor = ref.ReferenceHorizonNet(model.state_dict(), hw)(x)
    assert bon.shape == (2, 2, hw[1]) and cor.shape == (2, 1, hw[1])
    assert float((bon - want_bon).abs().max()) <= TOLERANCE
    assert float((cor - want_cor).abs().max()) <= TOLERANCE
    rows = hn.floor_boundary_rows(bon, hw[0])
    np.testing.assert_allclose(rows.numpy(), ref.floor_rows(want_bon, hw[0]).numpy(), atol=TOLERANCE * hw[0])
    # Below the horizon: a floor.
    assert float(rows.min()) > hw[0] / 2


def test_the_state_dict_is_the_released_key_layout_and_loads_strictly(tmp_path):
    model = hn.HorizonNet((64, 128))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == ref.state_shapes((64, 128))
    full = ref.state_shapes()
    assert full["bi_rnn.weight_ih_l0"] == (2048, 1024) and full["linear.weight"] == (12, 1024)
    assert full["reduce_height_module.ghc_lst.3.layer.0.layers.0.1.weight"] == (1024, 2048, 3, 3)
    assert hn.rnn_input_size(hn.INPUT_HW) == 1024
    # A checkpoint as HorizonNet's utils.save_model writes one.
    state = make_state_dict(2, "cpu", (64, 128))
    torch.save({"args": {}, "kwargs": {"backbone": "resnet50", "use_rnn": True}, "state_dict": state},
               tmp_path / "resnet50_rnn.pth")
    loaded = hn.load_horizonnet(str(tmp_path / "resnet50_rnn.pth"), (64, 128), device="cpu")
    assert not loaded.training
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, state[k]), k
    # The published bias initialisation of the output layer.
    np.testing.assert_array_equal(hn.HorizonNet((64, 128)).linear.bias.detach().numpy(),
                                  np.repeat(np.float32([-1.0, -0.478, 0.425]), 4))


def test_a_feature_at_column_zero_reaches_the_last_column_through_the_wrap():
    model = seeded((64, 128))
    x = rgb((64, 128), n=1)
    moved = x.clone()
    moved[:, :, 0] += 1.0
    with torch.no_grad():
        taps = model.feature_extractor(x.permute(0, 3, 1, 2))
        taps_moved = model.feature_extractor(moved.permute(0, 3, 1, 2))
    # The encoder's convolutions wrap: the first stage's last column sees column 0.
    assert float((taps[0][..., -1] - taps_moved[0][..., -1]).abs().max()) > 0
    assert float((taps[0][..., -8] - taps_moved[0][..., -8]).abs().max()) == 0
    # The width resample wraps: column 0 feeds the last output columns.
    planted = torch.zeros(1, 2, 1, 4)
    planted[..., 0] = 1.0
    out = hn.resample_width_wrapped(planted, 32)
    assert float(out[..., -1].min()) > 0 and float(out[..., 16].abs().max()) == 0
    np.testing.assert_allclose(out[0, 0, 0, :4].numpy(), [0.5625, 0.6875, 0.8125, 0.9375])
    np.testing.assert_allclose(out[0, 0, 0, -4:].numpy(), [0.0625, 0.1875, 0.3125, 0.4375])


def test_each_output_row_lands_on_its_published_column():
    """Linear(1024, 12)'s row 4 k + c is output k's column c of each step:
    with the weight zeroed and a bias of its own a row, every column reads
    its row's bias; with a row of random weights of its own a row, the port
    agrees with the reference column for column."""
    hw = (64, 128)
    model, x = seeded(hw), rgb(hw)
    state = model.state_dict()
    state["linear.weight"] = torch.randn(12, 1024, generator=torch.Generator().manual_seed(3)) / 32
    state["linear.bias"] = torch.arange(12, dtype=torch.float32)
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        bon, cor = model(x.permute(0, 3, 1, 2))
    want_bon, want_cor = ref.ReferenceHorizonNet(state, hw)(x)
    assert float((bon - want_bon).abs().max()) <= TOLERANCE
    assert float((cor - want_cor).abs().max()) <= TOLERANCE
    model.linear.weight.data.zero_()
    with torch.no_grad():
        bon, cor = model(x.permute(0, 3, 1, 2))
    want = torch.arange(12, dtype=torch.float32).view(3, 1, 4).expand(3, hw[1] // 4, 4).reshape(3, hw[1])
    assert torch.equal(torch.cat([cor, bon], dim=1), want.expand(2, 3, hw[1]))


@pytest.mark.parametrize("fault", ref.FAULTS)
def test_each_planted_fault_of_the_reference_is_far_outside_the_tolerance(fault):
    hw = (64, 128)
    model, x = seeded(hw), rgb(hw)
    with torch.no_grad():
        bon, _ = model(x.permute(0, 3, 1, 2))
    faulty, _ = ref.ReferenceHorizonNet(model.state_dict(), hw, fault=fault)(x)
    assert float((bon - faulty).abs().max()) > 100 * TOLERANCE


@pytest.mark.parametrize("precision", ["tf32", "bf16"])
def test_the_reference_in_a_lower_precision_is_outside_the_tolerance(precision):
    hw = (64, 128)
    model, x = seeded(hw), rgb(hw)
    with torch.no_grad():
        bon, _ = model(x.permute(0, 3, 1, 2))
    low, _ = ref.ReferenceHorizonNet(model.state_dict(), hw, precision)(x)
    assert float((bon - low).abs().max()) > 10 * TOLERANCE


def test_a_model_refuses_an_image_of_another_size():
    with pytest.raises(ValueError, match="built for"):
        hn.HorizonNet((64, 128))(torch.zeros(1, 3, 32, 64))
