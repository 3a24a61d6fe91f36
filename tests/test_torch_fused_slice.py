"""The port's fused scoring slice against salve_tpu, end to end, float32.

On the tiny setup of tests/pipeline/test_fused_inference.py (ResNet-18,
64x128 panos, img_px=100), JAX's and the port's `score_floor_hypotheses`
see the same banks and the same weights (carried by `state_dict_from_flax`),
in warp and in direct mode. Renders may differ in a few pixels where a
one-ulp sin/cos/atan2 difference moves a round(), so labels must be equal
and probabilities within 1e-3. The port's CLI writes batch_{i}.json files
that JAX's Stage D parser reads back with JAX's fp0/fp1/y_true.
"""

import glob
import json

import jax
import numpy as np
import pytest
import torch

from salve_tpu.cli.test_fused import score_building_fused as jax_score_building
from salve_tpu.common.alignment_hypothesis import AlignmentHypothesis as JaxHypothesis
from salve_tpu.common.edge_classification import get_edge_classifications_from_serialized_preds
from salve_tpu.geometry.sim2 import Sim2 as JaxSim2
from salve_tpu.pipeline.fused_inference import score_floor_hypotheses as jax_score
from salve_tpu.rendering.bev_pair import BEVRenderConfig as JaxRenderConfig
from salve_tpu.training import train as train_lib
from salve_tpu.training.config import TrainingConfig as JaxConfig
from salve_tpu_torch.cli.test_fused import score_building_fused
from salve_tpu_torch.common.alignment_hypothesis import AlignmentHypothesis
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet
from salve_tpu_torch.models.weights import state_dict_from_flax
from salve_tpu_torch.pipeline.fused_inference import score_floor_hypotheses
from salve_tpu_torch.rendering.bev_pair import BEVRenderConfig
from salve_tpu_torch.training.config import TrainingConfig

TINY = dict(num_layers=18, resize_h=64, resize_w=64, train_h=56, train_w=56,
            modalities=("ceiling_rgb_texture", "floor_rgb_texture"), compute_dtype="float32")
RENDER = dict(img_px=100, meters_per_px=0.1, crop_ratio=0.1)
POSES = [(0.0, 0.0, 0.0), (45.0, 1.0, -0.5), (90.0, -1.0, 0.5), (-150.0, 0.4, 0.9), (10.0, 0.3, 0.2)]


@pytest.fixture(scope="module")
def tiny():
    """JAX train state, the port's model with the same weights, and the banks."""
    state = train_lib.create_train_state(JaxConfig(**TINY), jax.random.PRNGKey(0), max_iter=10)
    model = EarlyFusionCEResnet(num_layers=18, compute_dtype="float32")
    params = jax.tree_util.tree_map(np.asarray, state.params)
    stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    model.load_state_dict(state_dict_from_flax(params, stats, 18), strict=True)
    rng = np.random.default_rng(0)
    depths = rng.uniform(1000, 4000, (2, 64, 128)).astype(np.uint16)
    rgbs = rng.uniform(0, 1, (2, 64, 128, 3)).astype(np.float32)
    return state, model, depths, rgbs


def _hyps(hyp_cls, sim2_cls):
    return [
        (3, 5, hyp_cls(i2Ti1=sim2_cls.from_theta_deg(th, np.array([tx, ty])),
                       wdo_alignment_object="door", i1_wdo_idx=k, i2_wdo_idx=0,
                       configuration="identity"))
        for k, (th, tx, ty) in enumerate(POSES)
    ]


@pytest.mark.parametrize("use_warp", [True, False], ids=["warp", "direct"])
def test_score_floor_hypotheses_matches_jax(tiny, use_warp):
    state, model, depths, rgbs = tiny
    ref = jax_score(state, JaxConfig(**TINY), depths, rgbs, {3: 0, 5: 1},
                    _hyps(JaxHypothesis, JaxSim2), batch_size=2,
                    render_cfg=JaxRenderConfig(**RENDER), use_warp_renders=use_warp)
    got = score_floor_hypotheses(model, TrainingConfig(**TINY), depths, rgbs, {3: 0, 5: 1},
                                 _hyps(AlignmentHypothesis, Sim2), batch_size=2,
                                 render_cfg=BEVRenderConfig(**RENDER),
                                 use_warp_renders=use_warp, device="cpu")
    assert len(got) == len(ref) == len(POSES)
    for g, r in zip(got, ref):
        assert (g.i1, g.i2, g.wdo_pair_uuid, g.configuration) == (r.i1, r.i2, r.wdo_pair_uuid, r.configuration)
    assert [g.y_hat for g in got] == [r.y_hat for r in ref]
    np.testing.assert_allclose([g.prob for g in got], [r.prob for r in ref], atol=1e-3, rtol=0)


def test_bank_rows_outside_the_bank_raise(tiny):
    _, model, depths, rgbs = tiny
    with pytest.raises(ValueError, match="bank rows"):
        score_floor_hypotheses(model, TrainingConfig(**TINY), depths, rgbs, {3: 0, 5: 2},
                               _hyps(AlignmentHypothesis, Sim2), batch_size=2,
                               render_cfg=BEVRenderConfig(**RENDER), device="cpu")


def _write_building(root, building_id="0999", floor_id="floor_01"):
    """Panos, depth cache and hypothesis JSONs for a 3-pano floor (the
    building of tests/pipeline/test_test_fused_cli.py)."""
    import imageio.v2 as imageio

    rng = np.random.default_rng(0)
    pano_dir = root / "zind" / building_id / "panos"
    pano_dir.mkdir(parents=True)
    depth_dir = root / "depth" / building_id
    depth_dir.mkdir(parents=True)
    for pid in (0, 2, 7):
        stem = f"{floor_id}_partial_room_{pid:02d}_pano_{pid}"
        imageio.imwrite(str(pano_dir / f"{stem}.jpg"), rng.integers(0, 255, (64, 128, 3)).astype(np.uint8))
        imageio.imwrite(str(depth_dir / f"{stem}.depth.png"),
                        rng.integers(1000, 4000, (512, 1024)).astype(np.uint16))
    pos = root / "hyp" / building_id / floor_id / "gt_alignment_approx"
    neg = root / "hyp" / building_id / floor_id / "incorrect_alignment"
    pos.mkdir(parents=True)
    neg.mkdir(parents=True)
    JaxSim2.from_theta_deg(30.0, np.array([1.0, 0.5])).save_as_json(str(pos / "0_2__door_0_1_identity.json"))
    JaxSim2.from_theta_deg(120.0, np.array([-2.0, 0.0])).save_as_json(str(neg / "0_2__door_0_0_rotated.json"))
    JaxSim2.from_theta_deg(-45.0, np.array([0.0, 3.0])).save_as_json(str(neg / "2_7__window_1_0_identity.json"))
    return building_id, floor_id


def _read_batches(preds_dir):
    out = {k: [] for k in ("y_hat", "y_true", "y_hat_probs", "fp0", "fp1")}
    for bf in sorted(glob.glob(str(preds_dir / "batch_*.json"))):
        data = json.load(open(bf))
        assert set(data) == set(out)
        for k in out:
            out[k] += data[k]
    return out


def test_cli_writes_what_jax_stage_d_parses(tiny, tmp_path):
    state, model, _, _ = tiny
    building_id, floor_id = _write_building(tmp_path)
    dirs = dict(hypotheses_save_root=str(tmp_path / "hyp"), raw_dataset_dir=str(tmp_path / "zind"),
                depth_save_root=str(tmp_path / "depth"))
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    n = score_building_fused(building_id, model=model, cfg=TrainingConfig(**TINY),
                             serialization_save_dir=str(tmp_path / "port"), batch_size=2,
                             render_cfg=BEVRenderConfig(**RENDER), device="cpu", **dirs)
    n_ref = jax_score_building(building_id, state=state, cfg=JaxConfig(**TINY),
                               serialization_save_dir=str(tmp_path / "jax"), batch_size=2,
                               render_cfg=JaxRenderConfig(**RENDER), **dirs)
    assert n == n_ref == 2

    got, ref = _read_batches(tmp_path / "port"), _read_batches(tmp_path / "jax")
    assert (got["fp0"], got["fp1"], got["y_true"]) == (ref["fp0"], ref["fp1"], ref["y_true"])
    assert got["y_hat"] == ref["y_hat"]
    np.testing.assert_allclose(got["y_hat_probs"], ref["y_hat_probs"], atol=1e-3, rtol=0)

    measurements = get_edge_classifications_from_serialized_preds(
        query_building_id=building_id, query_floor_id=floor_id,
        serialized_preds_json_dir=str(tmp_path / "port"),
        hypotheses_save_root=dirs["hypotheses_save_root"],
    )
    keyed = {(m.i1, m.i2, m.wdo_pair_uuid, m.configuration) for m in measurements[(building_id, floor_id)]}
    assert keyed == {(0, 2, "door_0_1", "identity"), (0, 2, "door_0_0", "rotated"),
                     (2, 7, "window_1_0", "identity")}


def test_model_weights_carry_over_exactly(tiny):
    """The port's model holds the Flax parameters unchanged (no rounding on
    the way): the head matches kernel.T element for element."""
    state, model, _, _ = tiny
    np.testing.assert_array_equal(model.fc.weight.detach().numpy(), np.asarray(state.params["fc"]["kernel"]).T)
    assert torch.equal(model.conv1.weight, torch.from_numpy(
        np.asarray(state.params["ResNet_0"]["conv_init"]["kernel"]).transpose(3, 2, 0, 1).copy()))
