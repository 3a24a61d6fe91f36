"""Stage D of the port against salve_tpu, end to end on procedural floors (CPU).

Inputs: procedural buildings through the port's GT-mode exporter (whose JSON
trees equal salve_tpu's, tests/test_torch_stage_a.py), and seeded verifier
predictions in the `batch_{i}.json` contract
(`salve_tpu_torch/dataset/seeded_predictions.py`: oracle labels, 15% of the
positives below the 0.93 threshold, 3 confident false positives a floor).
Both packages parse the same files and run `run_incremental_reconstruction`.

Nothing is patched: each package aligns its estimate to the ground truth
with its own float32 RANSAC Sim(3) fit. On these floors the chained poses
are near-exact, so every RANSAC hypothesis's mean rotation error is a few
float32 ulps and the sequential winner rule is decided by rounding; the
port's scorer reproduces XLA:CPU's float32 arithmetic bit for bit
(tests/test_torch_pose_alignment.py), so both pick the same winner. Held:
% localized and the top-2/3 component shares equal, the floorplan IoU equal,
the pose errors within 1e-6, the serialized aligned poses within 1e-9, and
`summary.json`'s keys equal and values within 1e-6.
"""

import json
import pathlib

import numpy as np
import pytest

from salve_tpu.algorithms import spanning_tree as jspanning_tree
from salve_tpu.cli import run_sfm as jrun_sfm
from salve_tpu_torch.algorithms import spanning_tree
from salve_tpu_torch.cli import run_sfm
from salve_tpu_torch.dataset import procedural
from salve_tpu_torch.dataset.seeded_predictions import (
    pano_image_paths,
    write_seeded_mhnet_predictions,
    write_seeded_predictions,
    write_seeded_vanishing_angles,
)
from salve_tpu_torch.hypotheses.export import export_single_building_wdo_alignment_hypotheses

from test_torch_bev_pairs import listing_sorted
from test_torch_stage_a import _write_building

# (seed, generate_building_json kwargs): two 4x4 floors (12-17 panos) and a
# default one.
FLOORS = [(0, {"n_rows": 4, "n_cols": 4}), (1, {"n_rows": 4, "n_cols": 4}), (2, {})]
WDO_TYPES = ["door", "window", "opening"]


def make_stage_d_inputs(root: pathlib.Path, floors=FLOORS, inferred: bool = False) -> dict:
    """ZInD-format buildings, GT-mode hypotheses and seeded predictions under
    `root`. With `inferred`: seeded MHNet predictions and vanishing angles,
    and the hypotheses exported from the MHNet layouts (inferred mode), as
    landmark SLAM and the axis alignment read them."""
    raw, hyp, preds, mh = root / "zind", root / "hyp", root / "preds", root / "mhnet"
    n = 0
    for seed, kwargs in floors:
        bid = f"{seed:04d}"
        building = procedural.generate_building_json(seed=seed, **kwargs)
        annot = _write_building(raw, bid, building)
        if inferred:
            write_seeded_mhnet_predictions(mh, bid, building, seed)
            write_seeded_vanishing_angles(mh, bid, building, seed)
        export_single_building_wdo_alignment_hypotheses(
            str(hyp), bid, annot, str(raw), inferred, str(mh) if inferred else None, device="cpu")
        n += write_seeded_predictions(str(hyp), bid, pano_image_paths(building), str(preds), seed=seed,
                                      start_batch_idx=n)
    return {"raw": str(raw), "hyp": str(hyp), "preds": str(preds), "mhnet": str(mh) if inferred else None,
            "n_floors": len(floors)}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_stage_d_inputs(tmp_path_factory.mktemp("stage_d"))


@pytest.fixture(scope="module")
def inferred_inputs(tmp_path_factory):
    return make_stage_d_inputs(tmp_path_factory.mktemp("stage_d_inferred"), floors=FLOORS[:1], inferred=True)


def same_rng_for_random_spanning_trees(monkeypatch, seed: int):
    """Both packages' `ransac_spanning_trees` draw from default_rng(seed)."""
    for mod in (spanning_tree, jspanning_tree):
        fn = mod.ransac_spanning_trees

        def seeded(*args, _fn=fn, **kwargs):
            return _fn(*args, rng=np.random.default_rng(seed), **kwargs)

        monkeypatch.setattr(mod, "ransac_spanning_trees", seeded)


def run_both(inputs, tmp_path, method, **kwargs):
    common = dict(
        hypotheses_save_root=inputs["hyp"], serialized_preds_json_dir=inputs["preds"],
        raw_dataset_dir=inputs["raw"], method=method, confidence_threshold=0.93,
        allowed_wdo_types=WDO_TYPES,
    )
    common.update(kwargs)
    common.setdefault("use_axis_alignment", False)
    common.setdefault("predictions_data_root", None)
    port = run_sfm.run_incremental_reconstruction(plot_save_dir=str(tmp_path / "port"), device="cpu", **common)
    ref = listing_sorted(jrun_sfm.run_incremental_reconstruction)(plot_save_dir=str(tmp_path / "ref"), **common)
    return port, ref


def assert_reports_match(port, ref, tmp_path, n_floors=len(FLOORS)):
    assert len(port) == len(ref) == n_floors
    for p, r in zip(port, ref):
        assert (p.building_id, p.floor_id) == (r.building_id, r.floor_id)
        assert p.percent_panos_localized == r.percent_panos_localized
        assert p.percent_in_top2_ccs == r.percent_in_top2_ccs or np.isnan(r.percent_in_top2_ccs)
        assert p.percent_in_top3_ccs == r.percent_in_top3_ccs or np.isnan(r.percent_in_top3_ccs)
        assert p.floorplan_iou == r.floorplan_iou
        np.testing.assert_allclose(p.avg_abs_rot_err, r.avg_abs_rot_err, rtol=0, atol=1e-6)
        np.testing.assert_allclose(p.avg_abs_trans_err, r.avg_abs_trans_err, rtol=0, atol=1e-6)
        if r.rotation_errors is not None:
            np.testing.assert_allclose(p.rotation_errors, r.rotation_errors, rtol=0, atol=1e-6)
            np.testing.assert_allclose(p.translation_errors, r.translation_errors, rtol=0, atol=1e-6)
    ps, rs = (json.loads((tmp_path / side / "summary.json").read_text()) for side in ("port", "ref"))
    assert ps.keys() == rs.keys() and len(ps) == 12
    for k in ps:
        np.testing.assert_allclose(ps[k], rs[k], rtol=0, atol=1e-6, err_msg=k)
    pser = sorted((tmp_path / "port_serialized").glob("*.json"))
    rser = sorted((tmp_path / "ref_serialized").glob("*.json"))
    assert [f.name for f in pser] == [f.name for f in rser]
    for pf, rf in zip(pser, rser):
        a, b = json.loads(pf.read_text()), json.loads(rf.read_text())
        assert a.keys() == b.keys() and a["wSi_dict"].keys() == b["wSi_dict"].keys()
        for i in a["wSi_dict"]:
            for key in ("R", "t", "s"):
                np.testing.assert_allclose(a["wSi_dict"][i][key], b["wSi_dict"][i][key], rtol=0, atol=1e-9)


# (method, run_incremental_reconstruction options): every method, and each
# option of the frozen configuration's neighbourhood.
CASES = [
    ("pose2_slam", {"rescue_clusters": True}),  # the frozen configuration
    ("pose2_slam", {}),
    ("pgo", {"resolve_rot_conflicts": True, "rescue_clusters": True}),
    ("spanning_tree", {"filter_edges_by_global_local_consistency": True}),
    ("random_spanning_trees", {}),
    ("spanning_tree", {"filter_edges_by_random_spanning_trees": True}),
    ("SE2_cycles", {}),
    ("filtered_spanning_tree", {}),
]


@pytest.mark.parametrize("method,options", CASES, ids=[f"{m}-{'-'.join(o) or 'plain'}" for m, o in CASES])
def test_reports_match_salve_tpu(inputs, tmp_path, monkeypatch, method, options):
    same_rng_for_random_spanning_trees(monkeypatch, seed=3)
    port, ref = run_both(inputs, tmp_path, method, **options)
    assert_reports_match(port, ref, tmp_path)
    if options.get("rescue_clusters"):
        assert min(r.percent_panos_localized for r in port) > 50.0


def test_landmark_slam_with_axis_alignment_matches_salve_tpu(inferred_inputs, tmp_path, monkeypatch):
    """pose2_slam with a predictions root: hypotheses from the MHNet layouts,
    W/D/O landmark factors on them, and vanishing-angle alignment of every
    edge."""
    port, ref = run_both(inferred_inputs, tmp_path, "pose2_slam", use_axis_alignment=True,
                         predictions_data_root=inferred_inputs["mhnet"], rescue_clusters=True)
    assert_reports_match(port, ref, tmp_path, n_floors=1)


def test_frozen_config_with_each_packages_alignment(inputs, tmp_path):
    """The frozen configuration: on every floor both packages' RANSAC picks
    the same Sim(3), so the serialized aligned poses are equal to the bit
    and the reports equal."""
    port, ref = run_both(inputs, tmp_path, "pose2_slam", rescue_clusters=True)
    differing = []
    for pf, rf in zip(sorted((tmp_path / "port_serialized").glob("*.json")),
                      sorted((tmp_path / "ref_serialized").glob("*.json"))):
        a, b = json.loads(pf.read_text()), json.loads(rf.read_text())
        if a["wSi_dict"] != b["wSi_dict"]:
            differing.append(pf.name)
    assert differing == [], f"aligned poses differ on {len(differing)} of {len(port)} floors: {differing}"
    for p, r in zip(port, ref):
        assert (p.floorplan_iou, p.avg_abs_rot_err, p.avg_abs_trans_err) == (
            r.floorplan_iou, r.avg_abs_rot_err, r.avg_abs_trans_err)


def test_cli_runs_on_the_cpu(inputs, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run_sfm.main([
        "--serialized_preds_json_dir", inputs["preds"], "--raw_dataset_dir", inputs["raw"],
        "--hypotheses_save_root", inputs["hyp"], "--method", "spanning_tree", "--use_axis_alignment", "false",
        "--rescue_clusters", "True", "--device", "cpu",
    ])
    out = list(tmp_path.glob("*spanning_tree*/summary.json"))
    assert len(out) == 1 and json.loads(out[0].read_text())["mean_percent_panos_localized"] > 50.0
    with pytest.raises(SystemExit):
        run_sfm.main(["--serialized_preds_json_dir", inputs["preds"], "--raw_dataset_dir", inputs["raw"],
                      "--hypotheses_save_root", inputs["hyp"], "--method", "no_such_method"])
