"""Stitching of the port against salve_tpu on the CPU (float64 throughout).

Inputs: procedural floors through the port's GT-mode exporter, seeded
verifier predictions and the port's `run_sfm` (pose2_slam, cluster rescue):
its serialized poses. Layouts come from `dataset/seeded_stitching.py` (made
from the true rooms, with noise and nonzero uncertainties) and, for one
case, from `write_seeded_mhnet_predictions`. Both packages read the same
files in one process (so string pano IDs hash alike and set orders agree).

Held exactly (tolerance: none):
  * `points_in_polygon_grid` against the numpy test, cell for cell, on
    seeded rings and where scanlines pass through vertices and along edges;
  * the room groups of both `group_panos_by_room`s, members in order;
  * every fused ring and confidence of `refine_predicted_shape`, bit for bit;
  * `stitch_building_layouts`' shapes and `stitch_clusters`' `score.json`.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from salve_tpu.algorithms import room_merging as jroom_merging
from salve_tpu.cli import stitch_floor_plan as jstitch
from salve_tpu.dataset import salve_sfm_result_loader as jloader
from salve_tpu.geometry.polygons import points_in_polygon
from salve_tpu.stitching import cluster_stitching as jcluster
from salve_tpu.stitching import shape as jshape
from salve_tpu_torch.algorithms import room_merging
from salve_tpu_torch.cli import run_sfm, stitch_floor_plan, stitch_floor_plan_clusters
from salve_tpu_torch.dataset import procedural, salve_sfm_result_loader, seeded_stitching
from salve_tpu_torch.dataset.seeded_predictions import write_seeded_mhnet_predictions
from salve_tpu_torch.ops import raster
from salve_tpu_torch.stitching import cluster_stitching, shape

from test_torch_stage_d import WDO_TYPES, make_stage_d_inputs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FLOORS = [(0, {"n_rows": 4, "n_cols": 4}), (1, {"n_rows": 4, "n_cols": 4})]


# -- the raster ------------------------------------------------------------------


def _star(rng, m: int, center=(0.0, 0.0), r=(1.0, 3.0)) -> np.ndarray:
    ang = np.sort(rng.uniform(0, 2 * np.pi, m))
    rad = rng.uniform(*r, m)
    return np.stack([center[0] + rad * np.cos(ang), center[1] + rad * np.sin(ang)], -1)


def _axes(poly: np.ndarray, res: float):
    lo, hi = poly.min(0) - res, poly.max(0) + res
    nx, ny = int(np.ceil((hi[0] - lo[0]) / res)), int(np.ceil((hi[1] - lo[1]) / res))
    return lo[0] + (np.arange(nx) + 0.5) * (hi[0] - lo[0]) / nx, lo[1] + (np.arange(ny) + 0.5) * (hi[1] - lo[1]) / ny


def _grid_cases():
    rng = np.random.default_rng(5)
    cases = {}
    for m in (3, 7, 64, 512, 1024):
        poly = _star(rng, m)
        cases[f"star{m}"] = (poly, *_axes(poly, 0.05))
    # Scanlines through vertices and along horizontal edges; columns on
    # vertical edges: the grid axes hold the vertices' own coordinates.
    steps = np.array([[0, 0], [2, 0], [2, 1], [3, 1], [3, 3], [1, 3], [1, 2], [0, 2]], np.float64) * 0.25
    cases["staircase on grid lines"] = (steps, np.linspace(-0.25, 1.0, 21), np.linspace(-0.25, 1.0, 21))
    diamond = np.array([[0.0, -1.0], [1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]])
    cases["diamond, rows through vertices"] = (diamond, np.linspace(-1.2, 1.2, 25), np.linspace(-1.0, 1.0, 21))
    comb = np.array([[0, 0], [5, 0], [5, 3], [4, 3], [4, 1], [3, 1], [3, 3], [2, 3], [2, 1], [1, 1], [1, 3],
                     [0, 3]], np.float64) / 7
    ys = np.unique(np.concatenate([comb[:, 1], np.linspace(-0.1, 0.5, 30)]))
    cases["comb, concave"] = (comb, np.unique(np.concatenate([comb[:, 0], np.linspace(-0.1, 0.8, 40)])), ys)
    dup = np.array([[0, 0], [0, 0], [1, 0], [1, 1], [1, 1], [0.5, 1], [0, 1]], np.float64)
    cases["repeated vertices"] = (dup, np.linspace(-0.2, 1.2, 29), np.linspace(-0.2, 1.2, 15))
    twisted = np.array([[0, 0], [1, 1], [1, 0], [0, 1]], np.float64)
    cases["self-intersecting"] = (twisted, np.linspace(-0.1, 1.1, 37), np.linspace(-0.1, 1.1, 37))
    return cases


GRID_CASES = _grid_cases()


@pytest.mark.parametrize("name", list(GRID_CASES))
def test_points_in_polygon_grid_equals_numpy(name):
    poly, xs, ys = GRID_CASES[name]
    grid = np.stack(np.meshgrid(xs, ys), axis=-1).reshape(-1, 2)
    want = points_in_polygon(poly, grid).reshape(len(ys), len(xs))
    got = raster.points_in_polygon_grid(torch.as_tensor(poly), xs, ys).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def test_points_in_polygon_grid_chunks_rows(monkeypatch):
    """A budget smaller than one row's product still gives the same mask, a
    row a chunk; and a float32 ring is refused (the reference is float64)."""
    poly, xs, ys = GRID_CASES["star512"]
    full = raster.points_in_polygon_grid(torch.as_tensor(poly), xs, ys)
    monkeypatch.setattr(raster, "GRID_CHUNK_ELEMENTS", 1000)
    assert torch.equal(raster.points_in_polygon_grid(torch.as_tensor(poly), xs, ys), full)
    with pytest.raises(ValueError, match="float64"):
        raster.points_in_polygon_grid(torch.as_tensor(poly, dtype=torch.float32), xs, ys)


def test_iou_and_union_raster_equal_salve_tpu():
    rng = np.random.default_rng(6)
    a = [_star(rng, 40, c) for c in ((0, 0), (4, 1))]
    b = [_star(rng, 300, c, (0.5, 2.5)) for c in ((0.5, 0.5), (3, 1), (20, 20))]
    for pa, pb in ((a, b), (a, []), (a[:1], a[:1])):
        assert shape.iou_between_polygon_sets(pa, pb, device="cpu") == jshape.iou_between_polygon_sets(pa, pb)
    assert shape.iou_between_polygon_sets([], [], device="cpu") == jshape.iou_between_polygon_sets([], [])
    (m, o), (jm, jo) = shape.rasterize_polygons_union(b, device="cpu"), jshape.rasterize_polygons_union(b)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(o, jo)
    for pa, pb in ((a[0], b[0]), (b[1], b[2]), (a[1], a[1])):
        assert room_merging._pairwise_overlap(pa, pb) == jroom_merging._pairwise_overlap(pa, pb)


# -- the stitching flows -----------------------------------------------------------


@pytest.fixture(scope="module")
def floors(tmp_path_factory):
    """Per floor: the raw dataset, run_sfm's serialized poses, seeded layouts
    (from the true rooms, and sinusoids) and the cluster flow's files."""
    root = tmp_path_factory.mktemp("stitching")
    inp = make_stage_d_inputs(root, FLOORS)
    run_sfm.run_incremental_reconstruction(
        hypotheses_save_root=inp["hyp"], serialized_preds_json_dir=inp["preds"], raw_dataset_dir=inp["raw"],
        method="pose2_slam", confidence_threshold=0.93, allowed_wdo_types=WDO_TYPES, use_axis_alignment=False,
        predictions_data_root=None, rescue_clusters=True, plot_save_dir=str(root / "sfm"), device="cpu")
    out = []
    for seed, kwargs in FLOORS:
        bid = f"{seed:04d}"
        building = procedural.generate_building_json(seed=seed, **kwargs)
        ser = str(root / "sfm_serialized" / f"{bid}__floor_01.json")
        seeded_stitching.write_layout_predictions(root / "layouts", bid, building, seed)
        write_seeded_mhnet_predictions(root / "sinusoids", bid, building, seed)
        clusters = seeded_stitching.write_cluster_inputs(root / f"clusters_{bid}", bid, building, ser, seed)
        out.append({"bid": bid, "raw": inp["raw"], "ser": ser, "layouts": str(root / "layouts"),
                    "sinusoids": str(root / "sinusoids"), **clusters})
    return out


def _capture(monkeypatch, module, name):
    """Record what `module.name` returns, calling it unchanged."""
    fn, seen = getattr(module, name), []

    def wrapper(*args, **kwargs):
        seen.append(fn(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(module, name, wrapper)
    return seen


def _rings_key(floor_shape_final):
    """Every fused boundary, confidence and pose, as exact floats."""
    return [[([(p.x, p.y) for p in xys], list(conf), (pose.position.x, pose.position.y, pose.rotation))
             for xys, conf, pose in group] for group in floor_shape_final]


@pytest.mark.parametrize("layouts", ["layouts", "sinusoids"])
@pytest.mark.parametrize("i", [0, 1])
def test_stitch_building_layouts_matches_salve_tpu(floors, tmp_path, monkeypatch, i, layouts):
    f = floors[i]
    groups = _capture(monkeypatch, jroom_merging, "group_panos_by_room")
    refined = _capture(monkeypatch, jshape, "refine_predicted_shape")
    jstitch.stitch_building_layouts(f["bid"], f[layouts], f["raw"], f["ser"], str(tmp_path / "ref"))
    final, fused = stitch_floor_plan.stitch_building_layouts(f["bid"], f[layouts], f["raw"], f["ser"],
                                                             str(tmp_path / "port"), device="cpu")
    ref_final, ref_fused = refined[0]
    assert _rings_key(final) == _rings_key(ref_final)
    assert len(fused) == len(ref_fused)
    for g, rg in zip(fused, ref_fused):
        assert len(g) == len(rg) and all(np.array_equal(a, b) for a, b in zip(g, rg))
    graph = salve_sfm_result_loader.load_estimated_pose_graph(
        pathlib.Path(f["ser"]), salve_sfm_result_loader.EstimatedBoundaryType.HNET_CORNERS, f["raw"], f[layouts])
    assert room_merging.group_panos_by_room(graph, device="cpu") == groups[0]
    if layouts == "layouts":
        # The layouts trace the true rooms: panos group into rooms, and a
        # group's fusion has several panos to choose between.
        assert max(len(g) for g in groups[0]) > 1 and len(groups[0]) > 2


def test_group_panos_by_room_on_estimated_graphs_matches(floors):
    """room_merging's grouping on each boundary type's pose graph: the same
    components, members in the same order."""
    for f in floors:
        for kind in ("HNET_CORNERS", "HNET_DENSE"):
            port_graph = salve_sfm_result_loader.load_estimated_pose_graph(
                pathlib.Path(f["ser"]), salve_sfm_result_loader.EstimatedBoundaryType[kind], f["raw"], f["layouts"])
            ref_graph = jloader.load_estimated_pose_graph(
                pathlib.Path(f["ser"]), jloader.EstimatedBoundaryType[kind], f["raw"], f["layouts"])
            assert room_merging.group_panos_by_room(port_graph, device="cpu") == \
                jroom_merging.group_panos_by_room(ref_graph)


@pytest.mark.parametrize("i", [0, 1])
def test_stitch_clusters_matches_salve_tpu(floors, tmp_path, monkeypatch, i):
    """String pano IDs: the shape module's grouping, the fusion and
    score.json, in one process."""
    f = floors[i]
    groups = _capture(monkeypatch, jshape, "group_panos_by_room")
    refined = _capture(monkeypatch, jshape, "refine_predicted_shape")
    ref = jcluster.stitch_clusters(f["clusters"], f["pred_dir"], f["floor_map"], str(tmp_path / "ref"), render=False)
    refined_port = _capture(monkeypatch, shape, "refine_predicted_shape")
    got = cluster_stitching.stitch_clusters(f["clusters"], f["pred_dir"], f["floor_map"], str(tmp_path / "port"),
                                            device="cpu")
    assert got == ref
    assert json.loads((tmp_path / "port" / "score.json").read_text()) == \
        json.loads((tmp_path / "ref" / "score.json").read_text())
    assert [_rings_key(r[0]) for r in refined_port] == [_rings_key(r[0]) for r in refined]
    assert len(ref) == 2 and all(0.5 < s["iou"] <= 1.0 for s in ref)
    assert any(len(g) > 1 for gs in groups for g in gs)


def test_shape_grouping_with_string_ids_matches(floors):
    """`shape.group_panos_by_room` on the cluster flow's corner shapes keyed
    by 10-hex strings, in file and in reversed order."""
    f = floors[0]
    preds, poses = {}, {}
    clusters = json.loads(pathlib.Path(f["clusters"]).read_text())
    for hid, rec in clusters[0]["panos"].items():
        data = json.loads((pathlib.Path(f["pred_dir"]) / hid / "rmx-madori-v1_predictions.json").read_text())
        preds[hid] = jshape.load_room_shape_polygon_from_predictions(data[0]["predictions"]["room_shape"]["corners_in_uv"])
        poses[hid] = shape.Pose(position=shape.Point2d(x=rec["pose"]["x"], y=rec["pose"]["y"]),
                                rotation=rec["pose"]["rotation"])
    for order in (list(poses), list(poses)[::-1]):
        loc = {k: poses[k] for k in order}
        assert shape.group_panos_by_room(preds, loc, device="cpu") == jshape.group_panos_by_room(preds, loc)


def test_clis_run_on_the_cpu(floors, tmp_path, capsys):
    f = floors[0]
    stitch_floor_plan.main(["--raw_dataset_dir", f["raw"], "--est-localization-fpath", f["ser"], "-o",
                            str(tmp_path / "a"), "--hnet-pred-dir", f["layouts"], "--device", "cpu"])
    assert (tmp_path / "a" / "fused").is_dir()
    stitch_floor_plan_clusters.main(["-o", str(tmp_path / "b"), "--est-localization-fpath", f["clusters"],
                                     "--hnet-pred-dir", f["pred_dir"], "--path-gt-floor-map", f["floor_map"],
                                     "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads((tmp_path / "b" / "score.json").read_text()) and len(printed) == 2
