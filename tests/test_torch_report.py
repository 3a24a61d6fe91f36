"""The port's floor report and raster `polygon_mask` against salve_tpu (CPU).

`polygon_mask` must equal JAX's mask bit for bit: rooms of procedural floors
as generated, with every vertex snapped to the pixel grid (scanlines through
vertices and edges on pixel centers: the crossing test's ties), jittered by
1e-3 px, and batched with padding. The reports are compared with salve_tpu's
own, each package aligning with its own RANSAC: IoU equal, errors within
1e-6, and the serialized aligned poses byte for byte.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salve_tpu.common import floor_reconstruction_report as jreport
from salve_tpu.common import posegraph2d as jposegraph2d
from salve_tpu.geometry.sim2 import Sim2 as JaxSim2
from salve_tpu.ops.raster import polygon_mask as jax_polygon_mask
from salve_tpu_torch.common import floor_reconstruction_report as report
from salve_tpu_torch.common import posegraph2d
from salve_tpu_torch.common.pano_data import FloorData
from salve_tpu_torch.dataset import procedural
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.ops.raster import polygon_mask

SIDE = 501


def _rooms(seed, mode, rng):
    b = procedural.generate_building_json(seed=seed, n_rows=4, n_cols=4)
    fd = FloorData.from_json(b["merger"]["floor_01"], "floor_01")
    scale = b["scale_meters_per_coordinate"]["floor_01"]
    out = []
    for p in fd.panos:
        img = (p.room_vertices_global_2d * scale + 25.0) / 0.1
        if mode == "snapped":
            img = np.round(img)
        elif mode == "jittered":
            img = img + rng.uniform(-1e-3, 1e-3, img.shape)
        out.append(img)
    return out


@pytest.mark.parametrize("mode", ["generated", "snapped", "jittered"])
def test_polygon_mask_is_bit_exact(mode):
    rng = np.random.default_rng(0)
    rooms = _rooms(0, mode, rng) + _rooms(3, mode, rng)
    filled = 0
    for img in rooms:
        v = np.zeros((max(64, len(img)), 2), np.float32)
        v[: len(img)] = img
        want = np.asarray(jax_polygon_mask(jnp.asarray(v), jnp.int32(len(img)), SIDE, SIDE))
        got = polygon_mask(torch.as_tensor(v), np.array(len(img)), SIDE, SIDE).numpy()
        assert got.dtype == bool and np.array_equal(got, want)
        filled += int(want.sum())
    assert filled > 50_000
    # Batched with padding to the longest room, as the report calls it.
    v = np.zeros((len(rooms), 64, 2), np.float32)
    for k, img in enumerate(rooms):
        v[k, : len(img)] = img
    counts = np.array([len(r) for r in rooms])
    got = polygon_mask(torch.as_tensor(v), counts, SIDE, SIDE).numpy()
    for k in range(len(rooms)):
        want = np.asarray(jax_polygon_mask(jnp.asarray(v[k]), jnp.int32(counts[k]), SIDE, SIDE))
        assert np.array_equal(got[k], want)


def test_polygon_mask_edge_cases():
    """Horizontal edges, a degenerate polygon, a triangle, no vertices."""
    cases = [
        np.array([[10, 10], [40, 10], [40, 30], [10, 30]], np.float32),
        np.array([[5.5, 7], [20.5, 7], [20.5, 7]], np.float32),
        np.array([[3, 3], [30, 12], [8, 29]], np.float32),
    ]
    for img in cases:
        v = np.zeros((64, 2), np.float32)
        v[: len(img)] = img
        want = np.asarray(jax_polygon_mask(jnp.asarray(v), jnp.int32(len(img)), 37, 45))
        assert np.array_equal(polygon_mask(torch.as_tensor(v), np.array(len(img)), 37, 45).numpy(), want)
    v = np.zeros((64, 2), np.float32)
    assert not polygon_mask(torch.as_tensor(v), np.array(0), 8, 8).numpy().any()


def _graphs(tmp_path, seed):
    b = procedural.generate_building_json(seed=seed, n_rows=4, n_cols=4)
    raw = tmp_path / "zind" / f"{seed:04d}"
    raw.mkdir(parents=True)
    (raw / "zind_data.json").write_text(json.dumps(b))
    gt = posegraph2d.get_gt_pose_graph(f"{seed:04d}", "floor_01", str(tmp_path / "zind"))
    jgt = jposegraph2d.get_gt_pose_graph(f"{seed:04d}", "floor_01", str(tmp_path / "zind"))
    # An estimate in its own frame, with noise, two outliers and one pano missing.
    rng = np.random.default_rng(seed)
    ids = sorted(gt.nodes)
    wSi, jwSi = [None] * (max(ids) + 1), [None] * (max(ids) + 1)
    for k, i in enumerate(ids[:-1]):
        p = gt.nodes[i].global_Sim2_local
        th = p.theta_deg + 40.0 + rng.normal(0, 0.5)
        t = p.translation * 1.3 + np.array([0.4, -0.2]) + rng.normal(0, 0.02, 2) + (1.5 if k in (2, 5) else 0.0)
        wSi[i], jwSi[i] = Sim2.from_theta_deg(th, t), JaxSim2.from_theta_deg(th, t)
    return (posegraph2d.PoseGraph2d.from_wSi_list(wSi, gt), gt,
            jposegraph2d.PoseGraph2d.from_wSi_list(jwSi, jgt), jgt)


@pytest.mark.parametrize("seed", [0, 4])
def test_report_matches_salve_tpu(tmp_path, seed):
    est, gt, jest, jgt = _graphs(tmp_path, seed)
    got = report.FloorReconstructionReport.from_est_floor_pose_graph(
        est, gt, plot_save_dir=str(tmp_path / "port"), device="cpu")
    want = jreport.FloorReconstructionReport.from_est_floor_pose_graph(jest, jgt, plot_save_dir=str(tmp_path / "ref"))
    assert got.percent_panos_localized == want.percent_panos_localized < 100.0
    assert got.floorplan_iou == want.floorplan_iou > 0.3
    for k in ("avg_abs_rot_err", "avg_abs_trans_err"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.rotation_errors, want.rotation_errors, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.translation_errors, want.translation_errors, rtol=0, atol=1e-6)
    assert (got.building_id, got.floor_id) == (want.building_id, want.floor_id)
    name = f"{seed:04d}__floor_01.json"
    assert (tmp_path / "port_serialized" / name).read_bytes() == (tmp_path / "ref_serialized" / name).read_bytes()
    # salve_tpu's two figures, the side-by-side floorplans and the IoU masks, byte for byte.
    figures = [f"{sub}/{seed:04d}_floor_01.jpg" for sub in ("{}", "{}__floorplan_iou")]
    for fig in figures:
        assert (tmp_path / fig.format("port")).read_bytes() == (tmp_path / fig.format("ref")).read_bytes()
    tree = {side: sorted(str(p.relative_to(tmp_path)).replace(side, "X", 1) for p in tmp_path.rglob(f"{side}*/*"))
            for side in ("port", "ref")}
    assert tree["port"] == tree["ref"] and len(tree["port"]) == 3

    g = report.rasterize_room(est, gt.scale_meters_per_coordinate, 500, 0.1, "cpu")
    w = jreport.rasterize_room(jest, jgt.scale_meters_per_coordinate, 500, 0.1)
    assert np.array_equal(g, w) and g.sum() > 1000


@pytest.mark.filterwarnings("ignore:Mean of empty slice", "ignore:All-NaN slice")
def test_summaries_match():
    rng = np.random.default_rng(1)
    reps, jreps = [], []
    for k in range(4):
        vals = dict(avg_abs_rot_err=rng.uniform(0, 5), avg_abs_trans_err=rng.uniform(0, 1),
                    percent_panos_localized=rng.uniform(50, 100), floorplan_iou=np.nan if k == 2 else rng.uniform(),
                    translation_errors=rng.uniform(0, 0.5, 6), percent_in_top2_ccs=rng.uniform(50, 100))
        reps.append(report.FloorReconstructionReport(**vals))
        jreps.append(jreport.FloorReconstructionReport(**vals))
    got, want = report.summarize_reports(reps), jreport.summarize_reports(jreps)
    assert got.keys() == want.keys() and np.isnan(got["mean_percent_in_top3_ccs"])
    np.testing.assert_equal(got, want)  # NaN equals NaN here
    assert report.summarize_reports([]) == jreport.summarize_reports([]) == {}
    for thr in (0.1, 0.25):
        assert report.compute_translation_errors_against_threshold(reps, thr) == \
            jreport.compute_translation_errors_against_threshold(jreps, thr)
    assert repr(reps[0]) == repr(jreps[0])
