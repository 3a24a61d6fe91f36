"""The port's figures against salve_tpu's, and the port without matplotlib.

Both packages draw the same figure on matplotlib's Agg backend in this
process, from the same inputs, and the written files are held equal byte
for byte (PNG and JPEG through the same matplotlib and Pillow; the PDF of
`make_precision_recall_plots` with `SOURCE_DATE_EPOCH` set, so its
creation date is fixed). Covered: `utils/{matplotlib_utils,
graph_rendering_utils}.py`, `PanoData.plot_room_layout`,
`PoseGraph2d.draw_edge`, the report's side-by-side floorplans and IoU
masks, `run_sfm.plot_confidence_histograms`, stitching's two figure
functions, each cluster's and the layouts flow's `final.png`, and each of
the eight plotting CLIs through `main(argv)` against the click command.

Inputs: a procedural floor (7 panos) through the GT-mode exporter, seeded
`batch_*.json` predictions and the port's `run_sfm` (its serialized poses),
seeded MHNet layouts, stitching layouts and cluster files, a seeded
OpenSfM reconstruction, a results JSON in the training loop's format, and a
ray-cast 512x1024 pano written as a JPEG and a u16 depth PNG.

With matplotlib hidden (`sys.modules["matplotlib"] = None`, how Python sees
a package that is not installed), the policy of `utils/plotting.py`:
rule (b), a figure beside a computation (the report, `run_sfm`, both
stitching flows) is left out, the JSONs and numbers are those of the run
with matplotlib, and one warning is logged; rule (a), a figure that is the
product (the CLIs and the drawing functions called directly) raises
`MatplotlibMissing` and writes nothing.
"""

import json
import logging
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from salve_tpu.cli import analyze_capture_order as j_capture  # noqa: E402
from salve_tpu.cli import make_precision_recall_plots as j_pr
from salve_tpu.cli import run_sfm as j_run_sfm
from salve_tpu.cli import stitch_floor_plan as j_stitch
from salve_tpu.cli import vis_zind_annotated_floorplans as j_vis_zind
from salve_tpu.cli import visualize_backprojected_depthmap as j_depthmap
from salve_tpu.cli import visualize_edge_classifications as j_edges
from salve_tpu.cli import visualize_floorplans_side_by_side_baselines as j_baselines
from salve_tpu.cli import visualize_inferred_layout_w_gt_poses as j_inferred
from salve_tpu.cli import visualize_loss_plot as j_loss
from salve_tpu.common import floor_reconstruction_report as j_report
from salve_tpu.common import posegraph2d as j_pg
from salve_tpu.stitching import cluster_stitching as j_cluster
from salve_tpu.stitching import draw as j_draw
from salve_tpu.stitching.models import Point2d as JPoint2d
from salve_tpu.stitching.models import Pose as JPose
from salve_tpu.utils import graph_rendering_utils as j_graph
from salve_tpu.utils import matplotlib_utils as j_mpl
from salve_tpu_torch.cli import analyze_capture_order, make_precision_recall_plots, run_sfm, stitch_floor_plan
from salve_tpu_torch.cli import vis_zind_annotated_floorplans, visualize_backprojected_depthmap
from salve_tpu_torch.cli import visualize_edge_classifications, visualize_floorplans_side_by_side_baselines
from salve_tpu_torch.cli import visualize_inferred_layout_w_gt_poses, visualize_loss_plot
from salve_tpu_torch.common import edge_classification
from salve_tpu_torch.common import floor_reconstruction_report as report
from salve_tpu_torch.common import posegraph2d
from salve_tpu_torch.dataset import procedural, seeded_sfm, seeded_stitching
from salve_tpu_torch.dataset.seeded_predictions import (
    pano_image_paths,
    write_seeded_mhnet_predictions,
    write_seeded_predictions,
)
from salve_tpu_torch.native import jpeg, png
from salve_tpu_torch.rendering.synthetic import render_synthetic_pano
from salve_tpu_torch.stitching import cluster_stitching, draw
from salve_tpu_torch.stitching.models import Point2d, Pose
from salve_tpu_torch.utils import graph_rendering_utils, matplotlib_utils, plotting
from salve_tpu_torch.visualization.pose_viz import plot_3d_poses

from test_torch_bev_pairs import listing_sorted
from test_torch_stage_d import WDO_TYPES, make_stage_d_inputs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEED, BID, FLOOR = 0, "0000", "floor_01"
FLOORS = [(SEED, {"n_rows": 2, "n_cols": 3})]


@pytest.fixture(autouse=True)
def fresh_matplotlib(monkeypatch):
    """Each test starts with no open figure and the default rcParams (the
    precision-recall plot sets the ggplot style), and with no side figure
    yet named in a warning of this process."""
    plt.close("all")
    monkeypatch.setattr(plotting, "_warned", set())
    with matplotlib.rc_context():
        yield
    plt.close("all")


@pytest.fixture(scope="module")
def floor(tmp_path_factory):
    root = tmp_path_factory.mktemp("plots")
    inp = make_stage_d_inputs(root, FLOORS)
    building = procedural.generate_building_json(seed=SEED, **FLOORS[0][1])
    sfm_kwargs = dict(hypotheses_save_root=inp["hyp"], serialized_preds_json_dir=inp["preds"],
                      raw_dataset_dir=inp["raw"], method="pose2_slam", confidence_threshold=0.93,
                      allowed_wdo_types=WDO_TYPES, use_axis_alignment=False, predictions_data_root=None,
                      rescue_clusters=True, device="cpu")
    sfm_reports = run_sfm.run_incremental_reconstruction(plot_save_dir=str(root / "sfm"), **sfm_kwargs)
    ser = str(root / "sfm_serialized" / f"{BID}__{FLOOR}.json")
    seeded_stitching.write_layout_predictions(root / "layouts", BID, building, SEED)
    clusters = seeded_stitching.write_cluster_inputs(root / "clusters", BID, building, ser, SEED)
    write_seeded_mhnet_predictions(root / "mhnet", BID, building, SEED)
    write_seeded_predictions(inp["hyp"], BID, pano_image_paths(building), str(root / "preds_b"), seed=SEED + 1)
    seeded_sfm.write_opensfm_reconstruction(str(root / "sfm_results"), inp["raw"], BID, FLOOR, seed=5)
    rng = np.random.default_rng(2)
    (root / "results-fields.json").write_text(json.dumps({
        f"{split}_{k}": rng.uniform(0.2, 1.0, 6).tolist() for split in ("train", "val") for k in ("avg_loss", "mAcc")}))
    cast = render_synthetic_pano(np.array([[-2.0, -1.5], [3.0, -1.5], [3.0, 2.5], [-2.0, 2.5]]), 1.5, seed=4)
    (root / "depth.png").write_bytes(png.encode_png(np.round(cast["depth"] * 1000).astype(np.uint16)))
    jpeg.write_jpeg(root / "pano.jpg", cast["rgb"])
    return dict(inp, root=root, ser=ser, clusters=clusters, building=building, sfm_kwargs=sfm_kwargs,
                sfm_reports=sfm_reports)


def _same_files(a: Path, b: Path, pattern: str = "*") -> list:
    """The relative paths under `a` and `b` (equal lists), their bytes equal."""
    fa = sorted(str(p.relative_to(a)) for p in a.rglob(pattern) if p.is_file())
    fb = sorted(str(p.relative_to(b)) for p in b.rglob(pattern) if p.is_file())
    assert fa == fb and fa
    for name in fa:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    return fa


def _draw_both(tmp_path, draw_ref, draw_port, name="fig.png", figsize=(6, 5)):
    """Each package draws into a fresh figure, saved as PNG; bytes equal."""
    out = []
    for side, fn in (("ref", draw_ref), ("port", draw_port)):
        plt.figure(figsize=figsize)
        fn(plt.gca())
        path = tmp_path / f"{side}_{name}"
        plt.savefig(path, dpi=80)
        plt.close("all")
        out.append(path.read_bytes())
    assert out[0] == out[1] and out[0][:4] == b"\x89PNG"


# -- the drawing modules ----------------------------------------------------------


def test_matplotlib_utils_equal_salve_tpu(tmp_path):
    rng = np.random.default_rng(0)
    poly = rng.uniform(-2, 2, (6, 2))
    poly = np.vstack([poly, poly[:1]])
    lines = [(label, rng.uniform(0, 1, 3), rng.uniform(0, 1, 3)) for label in ("a", "b", "a")]

    def scene(mod):
        def fn(ax):
            mod.draw_polygon_mpl(ax, poly, "r")
            mod.draw_polygon_mpl(ax, poly * 0.5, "b", linewidth=3)
            mod.plot_polygon_patch_mpl(poly * 0.7, ax, color="g", alpha=0.4, zorder=2)
            for label, x, y in lines:
                ax.plot(x, y, label=label)
            mod.legend_without_duplicate_labels(ax)
        return fn

    _draw_both(tmp_path, scene(j_mpl), scene(matplotlib_utils))


def test_graph_rendering_equal_salve_tpu(floor, tmp_path):
    errors = [0.0, 3.5, 11.0, 20.0, 45.0, -1.0]
    assert graph_rendering_utils.generate_edge_colors_from_error_magnitudes(errors) == \
        j_graph.generate_edge_colors_from_error_magnitudes(errors)
    gt, jgt = posegraph2d.get_gt_pose_graph(BID, FLOOR, floor["raw"]), j_pg.get_gt_pose_graph(BID, FLOOR, floor["raw"])
    ids = sorted(gt.nodes)
    edges = [(ids[k], ids[k + 1]) for k in range(len(ids) - 1)] + [(ids[0], ids[-1]), (ids[0], 999)]
    reports = {e: SimpleNamespace(gt_class=k % 2, R_error_deg=None if k == 2 else 4.0 * k) for k, e in enumerate(edges)}
    for scheme in ("by_gt_class", "by_error_magnitude"):
        kw = dict(two_view_reports_dict=reports, title=f"{BID} {scheme}", color_scheme=scheme)
        j_graph.draw_graph_topology(edges, jgt, save_fpath=str(tmp_path / "ref" / f"{scheme}.jpg"), **kw)
        graph_rendering_utils.draw_graph_topology(edges, gt, save_fpath=str(tmp_path / "port" / f"{scheme}.jpg"), **kw)
    measurements = edge_classification.get_edge_classifications_from_serialized_preds(
        BID, FLOOR, floor["preds"], floor["hyp"])[(BID, FLOOR)]
    assert len({m.y_true for m in measurements}) == 2
    j_graph.draw_multigraph(measurements, jgt, confidence_threshold=0.5, save_dir=str(tmp_path / "ref" / "multi"))
    graph_rendering_utils.draw_multigraph(measurements, gt, confidence_threshold=0.5,
                                          save_dir=str(tmp_path / "port" / "multi"))
    assert len(_same_files(tmp_path / "ref", tmp_path / "port")) == 3


@pytest.mark.parametrize("frame,scale", [("local", None), ("worldnormalized", None), ("worldmetric", 3.5),
                                         ("worldmetric", None)])
def test_plot_room_layout_equals_salve_tpu(floor, tmp_path, capsys, frame, scale):
    gt, jgt = posegraph2d.get_gt_pose_graph(BID, FLOOR, floor["raw"]), j_pg.get_gt_pose_graph(BID, FLOOR, floor["raw"])
    i = sorted(gt.nodes)[2]
    assert gt.nodes[i].all_wdos
    _draw_both(tmp_path, lambda ax: jgt.nodes[i].plot_room_layout(frame, show_plot=False,
                                                                   scale_meters_per_coordinate=scale),
               lambda ax: gt.nodes[i].plot_room_layout(frame, show_plot=False, scale_meters_per_coordinate=scale))
    assert ("Scale is required" in capsys.readouterr().out) == (frame == "worldmetric" and scale is None)


def test_draw_edge_equals_salve_tpu(floor, tmp_path):
    gt, jgt = posegraph2d.get_gt_pose_graph(BID, FLOOR, floor["raw"]), j_pg.get_gt_pose_graph(BID, FLOOR, floor["raw"])
    ids = sorted(gt.nodes)
    _draw_both(tmp_path, lambda ax: [jgt.draw_edge(a, b, c) for a, b, c in zip(ids, ids[1:], "rgbk")],
               lambda ax: [gt.draw_edge(a, b, c) for a, b, c in zip(ids, ids[1:], "rgbk")])


def test_report_figures_equal_salve_tpu(floor, tmp_path):
    """The side-by-side floorplans (with a GT floorplan into a directory, and
    without one to a given path) and the IoU masks of one aligned estimate."""
    gt, jgt = posegraph2d.get_gt_pose_graph(BID, FLOOR, floor["raw"]), j_pg.get_gt_pose_graph(BID, FLOOR, floor["raw"])
    inferred = {}
    for side, pkg, g in (("ref", j_report, jgt), ("port", report, gt)):
        pkg.render_floorplans_side_by_side(g, plot_save_dir=str(tmp_path / side / "sbs"), gt_floor_pg=g)
        pkg.render_floorplans_side_by_side(g, plot_save_fpath=str(tmp_path / side / "alone.jpg"))
        kw = dict(device="cpu") if pkg is report else {}
        inferred[side] = pkg.render_raster_occupancy(g, g, plot_save_dir=str(tmp_path / side / "iou"), save_viz=True,
                                                     **kw)
    assert inferred["ref"] == inferred["port"] > 0.999
    assert len(_same_files(tmp_path / "ref", tmp_path / "port")) == 3


def test_plot_confidence_histograms_equal_salve_tpu(floor, tmp_path):
    measurements = edge_classification.get_edge_classifications_from_serialized_preds(
        BID, FLOOR, floor["preds"], floor["hyp"])[(BID, FLOOR)]
    j_run_sfm.plot_confidence_histograms(measurements, str(tmp_path / "ref.png"))
    run_sfm.plot_confidence_histograms(measurements, str(tmp_path / "port.png"))
    assert (tmp_path / "ref.png").read_bytes() == (tmp_path / "port.png").read_bytes()


def _stitch_inputs(models):
    point, pose = models
    rng = np.random.default_rng(3)
    shapes = {k: [point(x=float(x), y=float(y)) for x, y in rng.uniform(-2, 2, (5, 2))] for k in range(4)}
    poses = {k: pose(position=point(x=float(k), y=float(-k) * 0.5), rotation=30.0 * k) for k in range(4)}
    return shapes, poses


def test_stitching_figure_functions_equal_salve_tpu(tmp_path):
    (jshapes, jposes), (shapes, poses) = _stitch_inputs((JPoint2d, JPose)), _stitch_inputs((Point2d, Pose))
    groups = [[0, 2], [1], [3]]
    for side, mod, s, p in (("ref", j_draw, jshapes, jposes), ("port", draw, shapes, poses)):
        (tmp_path / side).mkdir()
        mod.draw_all_room_shapes_with_given_poses_and_shapes(str(tmp_path / side / "given.png"), s, p, groups)
        polys = mod.draw_all_room_shapes_with_poses(str(tmp_path / side / "poses.png"), s, p)
        np.save(tmp_path / side / "polys.npy", np.stack(polys))
        plt.close("all")
    assert len(_same_files(tmp_path / "ref", tmp_path / "port")) == 3


def _stitch_both_flows(floor, out: Path):
    """The port's two stitching flows on the fixture's floor, into `out`."""
    c = floor["clusters"]
    shapes = stitch_floor_plan.stitch_building_layouts(BID, str(floor["root"] / "layouts"), floor["raw"],
                                                       floor["ser"], str(out / "layouts"), device="cpu")
    scores = cluster_stitching.stitch_clusters(c["clusters"], c["pred_dir"], c["floor_map"], str(out / "clusters"),
                                               device="cpu")
    return shapes, scores


@pytest.fixture(scope="module")
def stitched(floor, tmp_path_factory):
    """The port's stitching outputs with matplotlib, and the flows' results."""
    out = tmp_path_factory.mktemp("stitched")
    return out, _stitch_both_flows(floor, out)


def test_stitched_final_pngs_equal_salve_tpu(floor, stitched, tmp_path):
    """`final.png` of the layouts flow and of each cluster, with score.json."""
    j_stitch.stitch_building_layouts(BID, str(floor["root"] / "layouts"), floor["raw"], floor["ser"],
                                     str(tmp_path / "layouts"))
    c = floor["clusters"]
    j_cluster.stitch_clusters(c["clusters"], c["pred_dir"], c["floor_map"], str(tmp_path / "clusters"))
    port = stitched[0]
    files = _same_files(tmp_path, port, "*.png")
    assert "layouts/fused/final.png" in files and sum(f.startswith("clusters/fused/") for f in files) >= 1
    assert (tmp_path / "clusters/score.json").read_bytes() == (port / "clusters/score.json").read_bytes()


# -- the eight CLIs ---------------------------------------------------------------


def _click(cmd, argv):
    return cmd.main(args=list(argv), standalone_mode=False)


def _cli_cases(floor):
    raw, hyp, preds, root = floor["raw"], floor["hyp"], floor["preds"], floor["root"]
    return {
        "analyze_capture_order": (j_capture.run_analyze_capture_order, analyze_capture_order,
                                  ["--hypotheses_save_root", hyp, "--save_fpath", "OUT/capture.png"]),
        "make_precision_recall_plots": (j_pr.run_make_precision_recall_plots, make_precision_recall_plots,
                                        ["--serialized_preds_json_dir", preds, "--model_name", "seed 0",
                                         "--serialized_preds_json_dir", str(root / "preds_b"), "--model_name",
                                         "seed 1", "--save_fpath", "OUT/pr.pdf"]),
        "visualize_loss_plot": (j_loss.run_visualize_loss_plot, visualize_loss_plot,
                                ["--train_results_fpath", str(root / "results-fields.json"), "--save_fpath",
                                 "OUT/loss.png"]),
        "vis_zind_annotated_floorplans": (j_vis_zind.run_vis_zind_annotated_floorplans, vis_zind_annotated_floorplans,
                                          ["--raw_dataset_dir", raw, "--save_dir", "OUT"]),
        "visualize_backprojected_depthmap": (j_depthmap.run_visualize_backprojected_depthmap,
                                             visualize_backprojected_depthmap,
                                             ["--depth_fpath", str(root / "depth.png"), "--rgb_fpath",
                                              str(root / "pano.jpg"), "--save_fpath", "OUT/bev.png"]),
        "visualize_edge_classifications": (j_edges.run_visualize_edge_classifications, visualize_edge_classifications,
                                           ["--serialized_preds_json_dir", preds, "--hypotheses_save_root", hyp,
                                            "--raw_dataset_dir", raw, "--confidence_threshold", "0.6", "--save_dir",
                                            "OUT"]),
        "visualize_floorplans_side_by_side_baselines": (
            j_baselines.run_visualize_floorplans_side_by_side_baselines, visualize_floorplans_side_by_side_baselines,
            ["--raw_dataset_dir", raw, "--results_dir", str(root / "sfm_results"), "--algorithm_name", "opensfm",
             "--save_dir", "OUT"]),
        "visualize_inferred_layout_w_gt_poses": (
            j_inferred.run_visualize_inferred_layout_w_gt_poses, visualize_inferred_layout_w_gt_poses,
            ["--raw_dataset_dir", raw, "--mhnet_predictions_data_root", str(root / "mhnet"), "--building_id", BID,
             "--save_dir", "OUT"]),
    }


CLIS = ["analyze_capture_order", "make_precision_recall_plots", "visualize_loss_plot", "vis_zind_annotated_floorplans",
        "visualize_backprojected_depthmap", "visualize_edge_classifications",
        "visualize_floorplans_side_by_side_baselines", "visualize_inferred_layout_w_gt_poses"]
DEVICE_CLIS = ("visualize_backprojected_depthmap", "visualize_floorplans_side_by_side_baselines")


@pytest.mark.parametrize("cli", CLIS)
def test_cli_writes_salve_tpus_files(floor, tmp_path, monkeypatch, capsys, cli):
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")
    click_cmd, port, argv = _cli_cases(floor)[cli]
    out = {}
    for side in ("ref", "port"):
        args = [a.replace("OUT", str(tmp_path / side)) for a in argv]
        (tmp_path / side).mkdir()
        if side == "ref":
            listing_sorted(_click)(click_cmd, args)
        else:
            port.main(args + (["--device", "cpu"] if cli in DEVICE_CLIS else []))
        plt.close("all")
        out[side] = capsys.readouterr().out.replace(str(tmp_path / side), "OUT")
    files = _same_files(tmp_path / "ref", tmp_path / "port")
    assert out["ref"] == out["port"]
    kinds = {Path(f).suffix for f in files}
    assert kinds & {".png", ".jpg", ".pdf"}, files


# -- without matplotlib -------------------------------------------------------------


@pytest.fixture
def no_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not plotting.installed()


def _warnings(caplog) -> list:
    return [r.getMessage() for r in caplog.records
            if r.name == plotting.__name__ and r.levelno == logging.WARNING]


def _json_files(root: Path) -> dict:
    return {str(p.relative_to(root)): json.loads(p.read_text()) for p in sorted(root.rglob("*.json"))
            if p.name != "stage_timings.json"}


def _figures(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.suffix in (".jpg", ".png", ".pdf"))


def test_report_without_matplotlib_writes_the_rest(floor, tmp_path, monkeypatch, caplog):
    gt = posegraph2d.get_gt_pose_graph(BID, FLOOR, floor["raw"])
    est = posegraph2d.PoseGraph2d.from_wSi_list(
        [gt.nodes[i].global_Sim2_local if i in gt.nodes else None for i in range(max(gt.nodes) + 1)], gt)
    with_mpl = report.FloorReconstructionReport.from_est_floor_pose_graph(
        est, gt, plot_save_dir=str(tmp_path / "with" / "viz"), device="cpu")
    assert _figures(tmp_path / "with") == [f"viz/{BID}_{FLOOR}.jpg", f"viz__floorplan_iou/{BID}_{FLOOR}.jpg"]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    caplog.set_level(logging.WARNING)
    for _ in range(2):
        without = report.FloorReconstructionReport.from_est_floor_pose_graph(
            est, gt, plot_save_dir=str(tmp_path / "without" / "viz"), device="cpu")
    assert _figures(tmp_path / "without") == []
    assert _json_files(tmp_path / "with") == _json_files(tmp_path / "without") != {}
    for k in ("avg_abs_rot_err", "avg_abs_trans_err", "percent_panos_localized", "floorplan_iou"):
        assert getattr(with_mpl, k) == getattr(without, k)
    warned = _warnings(caplog)
    assert len(warned) == 1 and "IoU mask" in warned[0] and "side-by-side" in warned[0]


def test_run_sfm_without_matplotlib_writes_the_rest(floor, tmp_path, monkeypatch, caplog):
    """Against the fixture's run of the same call with matplotlib."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    caplog.set_level(logging.WARNING)
    without = run_sfm.run_incremental_reconstruction(plot_save_dir=str(tmp_path / "sfm"), **floor["sfm_kwargs"])
    root = floor["root"]
    assert len(_figures(root / "sfm") + _figures(root / "sfm__floorplan_iou")) == 2 and _figures(tmp_path) == []
    want = {f"{d}/{p.name}": json.loads(p.read_text()) for d in ("sfm", "sfm_serialized")
            for p in sorted((root / d).glob("*.json")) if p.name != "stage_timings.json"}
    got = _json_files(tmp_path)
    assert got == want and "sfm/summary.json" in got and f"sfm_serialized/{BID}__{FLOOR}.json" in got
    assert [(r.floorplan_iou, r.avg_abs_trans_err) for r in without] == [
        (r.floorplan_iou, r.avg_abs_trans_err) for r in floor["sfm_reports"]]
    assert len(_warnings(caplog)) == 1


def test_stitching_without_matplotlib_writes_the_rest(floor, stitched, tmp_path, monkeypatch, caplog):
    with_dir, with_mpl = stitched
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    caplog.set_level(logging.WARNING)
    without = _stitch_both_flows(floor, tmp_path)
    assert "layouts/fused/final.png" in _figures(with_dir) and _figures(tmp_path) == []
    assert _json_files(with_dir) == _json_files(tmp_path) != {}
    assert without[1] == with_mpl[1]
    (_, fused_a), (_, fused_b) = with_mpl[0], without[0]
    assert len(fused_a) == len(fused_b) and all(
        np.array_equal(x, y) for ga, gb in zip(fused_a, fused_b) for x, y in zip(ga, gb))
    warned = _warnings(caplog)
    assert len(warned) == 1 and "final.png" in warned[0]


def _drawing_calls(floor, out: Path):
    """Each rule-(a) entry point that is not a CLI: a drawing function called directly."""
    gt = posegraph2d.get_gt_pose_graph(BID, FLOOR, floor["raw"])
    ids = sorted(gt.nodes)
    shapes, poses = _stitch_inputs((Point2d, Pose))
    return {
        "render_floorplans_side_by_side": lambda: report.render_floorplans_side_by_side(
            gt, plot_save_dir=str(out / "sbs"), gt_floor_pg=gt),
        "render_raster_occupancy(save_viz=True)": lambda: report.render_raster_occupancy(
            gt, gt, plot_save_dir=str(out / "iou"), save_viz=True, device="cpu"),
        "plot_confidence_histograms": lambda: run_sfm.plot_confidence_histograms([], str(out / "hist.png")),
        "draw_graph_topology": lambda: graph_rendering_utils.draw_graph_topology(
            [(ids[0], ids[1])], gt, save_fpath=str(out / "topology.jpg")),
        "draw_multigraph": lambda: graph_rendering_utils.draw_multigraph([], gt, save_dir=str(out / "multi")),
        "plot_polygon_patch_mpl": lambda: matplotlib_utils.plot_polygon_patch_mpl(np.eye(3)[:, :2], None),
        "plot_room_layout": lambda: gt.nodes[ids[0]].plot_room_layout("local", show_plot=False),
        "draw_edge": lambda: gt.draw_edge(ids[0], ids[1], "r"),
        "draw_all_room_shapes_with_given_poses_and_shapes": (
            lambda: draw.draw_all_room_shapes_with_given_poses_and_shapes(str(out / "given.png"), shapes, poses,
                                                                          [[0, 1]])),
        "draw_all_room_shapes_with_poses": lambda: draw.draw_all_room_shapes_with_poses(
            str(out / "poses.png"), shapes, poses),
        "plot_metrics": lambda: visualize_loss_plot.plot_metrics(str(floor["root"] / "results-fields.json"),
                                                                 str(out / "loss.png")),
        "compare_precision_recall_across_models": lambda: (
            make_precision_recall_plots.compare_precision_recall_across_models({"a": floor["preds"]},
                                                                               str(out / "pr.pdf"))),
        "plot_3d_poses": lambda: plot_3d_poses([], [], save_fpath=str(out / "poses3d.png")),
        "draw_bev_images": lambda: visualize_backprojected_depthmap.draw_bev_images(
            [("floor", np.zeros((4, 4, 3), np.uint8))], str(out / "bev.png")),
    }


def test_rule_a_entry_points_raise_and_write_nothing(floor, tmp_path, no_matplotlib, caplog):
    caplog.set_level(logging.WARNING)
    out = tmp_path / "out"
    for name, call in _drawing_calls(floor, out).items():
        with pytest.raises(plotting.MatplotlibMissing, match="needs matplotlib"):
            call()
    for cli, (_, port, argv) in _cli_cases(floor).items():
        args = [a.replace("OUT", str(out / cli)) for a in argv]
        with pytest.raises(plotting.MatplotlibMissing, match=f"{cli} needs matplotlib"):
            port.main(args + (["--device", "cpu"] if cli in DEVICE_CLIS else []))
    assert not out.exists() and _warnings(caplog) == []


def test_card_clis_computations_run_without_matplotlib(floor, tmp_path, no_matplotlib):
    """The two CLIs that reach the card split their computation from the
    figure: the depth map's two BEV images, and the baseline floors' reports
    (whose figures are then side figures), without matplotlib."""
    root = floor["root"]
    images = visualize_backprojected_depthmap.backprojected_bev_images(str(root / "depth.png"), str(root / "pano.jpg"),
                                                                       device="cpu")
    assert [t for t, _ in images] == ["floor", "ceiling"]
    assert all(img.shape == (501, 501, 3) and img.dtype == np.uint8 and img.any() for _, img in images)
    reports = visualize_floorplans_side_by_side_baselines.baseline_floor_reports(
        floor["raw"], str(root / "sfm_results"), "opensfm", str(tmp_path / "out"), device="cpu")
    assert len(reports) == 1 and 0 < reports[0].percent_panos_localized < 100
    assert _figures(tmp_path / "out") == [] and (tmp_path / "out" / "result_summaries").is_dir()
