"""Rules of the PyTorch port: no JAX, the card by default, no hidden fallback.

Every `salve_tpu_torch` module and `chip_smoke.py` import neither jax, flax,
optax, networkx, click, imageio, PIL, cv2, matplotlib, yaml nor msgpack nor
any `salve_tpu` module (every figure takes matplotlib through
`utils/plotting.py`, which imports it inside its functions), and no build
of the port links a JPEG library; the CLIs start with
only the standard library, torch, numpy and scipy, and those that reach the
card take `--device` and parse every flag of their click original; entry points given no
device run on the CUDA card and raise without one; each CUDA kernel wrapper
launches its kernel or raises, and takes the plain version only for CPU
tensors.
"""

import ast
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from salve_tpu_torch import device as device_mod
from salve_tpu_torch.ops import fill, kernels, splat, warp
from salve_tpu_torch.rendering import layout as layout_render
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "salve_tpu", "networkx", "click", "imageio", "PIL", "cv2", "matplotlib",
             "yaml", "msgpack")
# Packages the card's machine lacks: the CLIs must start without them.
ABSENT_ON_THE_CARD = ("jax", "flax", "optax", "salve_tpu", "networkx", "click", "matplotlib", "imageio", "PIL",
                      "cv2", "sklearn", "yaml", "msgpack")


def _port_files():
    files = sorted((REPO / "salve_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


# Every figure of the port takes matplotlib through the plotting helper,
# which imports it inside its functions, so every module and CLI still
# starts without it.
FUNCTION_LOCAL_IMPORTS = {"salve_tpu_torch/utils/plotting.py": {"matplotlib"}}


def _imported_roots(path: pathlib.Path):
    """(module, imported inside a function) for every import of `path`."""
    tree = ast.parse(path.read_text(), filename=str(path))
    local = {id(n) for f in ast.walk(tree) if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
             for n in ast.walk(f)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, id(node) in local
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module, id(node) in local


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 20
    # The rule covers the mesh and the host helpers too.
    covered = {str(f.relative_to(REPO)) for f in files}
    assert {"salve_tpu_torch/parallel/__init__.py", "salve_tpu_torch/parallel/mesh.py",
            "salve_tpu_torch/utils/transform.py", "salve_tpu_torch/utils/function_timeout.py",
            "salve_tpu_torch/utils/csv_utils.py", "salve_tpu_torch/utils/mesh_grid.py"} <= covered
    bad = []
    for f in files:
        rel = str(f.relative_to(REPO))
        for name, in_function in _imported_roots(f):
            root = name.split(".")[0]
            if root in FORBIDDEN and not (in_function and root in FUNCTION_LOCAL_IMPORTS.get(rel, ())):
                bad.append(f"{rel}: {name}")
    assert not bad, bad
    # The exception is used: the plotting helper imports matplotlib, and only there.
    helper = REPO / "salve_tpu_torch/utils/plotting.py"
    roots = {(name.split(".")[0], local) for name, local in _imported_roots(helper)}
    assert ("matplotlib", True) in roots and ("matplotlib", False) not in roots


def _salve_tpu_paths(source: str, exempt_names=()) -> list:
    """(line, text) of each string of `source` that names a path under
    salve_tpu/: docstrings, comments and the values assigned to
    `exempt_names` are left out."""
    tree = ast.parse(source)
    exempt = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and body and \
                isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
            exempt.add(id(body[0].value))
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id in exempt_names
                                                for t in node.targets):
            exempt.update(id(n) for n in ast.walk(node.value))
    return [(node.lineno, node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in exempt
            and (node.value == "salve_tpu" or re.search(r"(?<![\w.])salve_tpu/", node.value))]


def test_no_port_file_names_a_file_of_salve_tpu():
    """The port keeps its own copies of what it reads (salve_tpu_torch/configs/
    among them): no module of the port and no line of chip_smoke.py names a
    path under salve_tpu/. Docstrings and comments may cite the reference,
    and chip_smoke.py's kernel labels (`REPLACES`) name the Pallas kernel
    each CUDA kernel replaces."""
    bad = []
    for f in _port_files():
        exempt = ("REPLACES",) if f.name == "chip_smoke.py" else ()
        bad += [f"{f.relative_to(REPO)}:{line}: {text!r}" for line, text in _salve_tpu_paths(f.read_text(), exempt)]
    assert not bad, bad
    # The rule sees a path in code, in an f-string and as a path component,
    # and passes the exempt forms.
    probe = ('"""Reads salve_tpu/configs/default.yaml."""\n'
             'A = "salve_tpu/configs/default.yaml"  # salve_tpu/x\n'
             'B = f"{root}/salve_tpu/ops/bev.py"\n'
             'C = Path("repo") / "salve_tpu" / "configs"\n'
             'D = "salve_tpu_torch/configs/default.yaml"\n'
             'REPLACES = {"splat": "salve_tpu/ops/pallas_splat.py:77"}\n')
    assert [line for line, _ in _salve_tpu_paths(probe, ("REPLACES",))] == [2, 3, 4]


CARD_CLIS = ["run_sfm", "export_alignment_hypotheses", "test_fused", "stitch_floor_plan", "stitch_floor_plan_clusters",
             "render_dataset_bev", "train", "test", "train_depth", "batch_hohonet_inference", "end_to_end_eval",
             "register_depth_maps_icp", "eval_floorplan", "evaluate_sfm_baseline", "visualize_backprojected_depthmap",
             "visualize_floorplans_side_by_side_baselines"]
HOST_CLIS = ["sanity_check_gt_pose_graphs", "compute_average_zind_stats", "estimate_completion_percent",
             "measure_acc_vs_overlap", "split_vanishing_angle_file", "analyze_predictions", "execute_opensfm",
             "execute_openmvg", "analyze_capture_order", "make_precision_recall_plots", "visualize_loss_plot",
             "vis_zind_annotated_floorplans", "visualize_edge_classifications", "visualize_inferred_layout_w_gt_poses"]


def test_clis_start_without_packages_the_card_lacks():
    """Each CLI prints its help in a process where the packages the card's
    machine lacks are absent."""
    import subprocess
    import sys

    # A None entry in sys.modules is how Python sees a package that is not
    # installed: import raises ImportError and importlib.util.find_spec
    # returns None (torch probes optional packages that way). All CLIs start
    # in one process: each one's --help is captured on its own.
    script = (
        "import contextlib, importlib, io, json, sys\n"
        f"sys.modules.update(dict.fromkeys({ABSENT_ON_THE_CARD!r}))\n"
        "helps = {}\n"
        "for cli in sys.argv[1:]:\n"
        "    out = io.StringIO()\n"
        "    with contextlib.redirect_stdout(out):\n"
        "        try:\n"
        "            importlib.import_module(f'salve_tpu_torch.cli.{cli}').main(['--help'])\n"
        "        except SystemExit as e:\n"
        "            assert e.code == 0, (cli, e.code)\n"
        "    helps[cli] = out.getvalue()\n"
        "print(json.dumps(helps))\n"
    )
    out = subprocess.run([sys.executable, "-c", script, *CARD_CLIS, *HOST_CLIS], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    helps = json.loads(out.stdout.splitlines()[-1])
    assert sorted(helps) == sorted(CARD_CLIS + HOST_CLIS)
    for cli, text in helps.items():
        assert text.startswith("usage:"), cli
        # The CLIs that reach the card take --device; the host-only ones do not.
        assert ("--device" in text) == (cli in CARD_CLIS), cli


def test_cli_flags_parse_as_the_click_clis_did(tmp_path):
    """click's bool words, a tri-state warp flag, and paths that must exist."""
    from salve_tpu_torch.cli import run_sfm, test_fused
    from salve_tpu_torch.cli.args import boolean

    assert [boolean(v) for v in ("True", "yes", "1", "on", "t")] == [True] * 5
    assert [boolean(v) for v in ("false", "NO", "0", "off", "F")] == [False] * 5
    d = str(tmp_path)
    base = ["--hypotheses_save_root", d, "--raw_dataset_dir", d, "--depth_save_root", d, "--ckpt_fpath", d,
            "--serialization_save_dir", d]
    parser = test_fused.build_parser()
    assert parser.parse_args(base).use_warp_renders is None
    assert parser.parse_args(base + ["--use_warp_renders"]).use_warp_renders is True
    assert parser.parse_args(base + ["--no_warp_renders"]).use_warp_renders is False
    sfm = ["--serialized_preds_json_dir", d, "--raw_dataset_dir", d, "--hypotheses_save_root", d,
           "--method", "pgo"]
    args = run_sfm.build_parser().parse_args(sfm + ["--rescue_clusters", "yes"])
    assert (args.use_axis_alignment, args.rescue_clusters, args.confidence_threshold, args.device) == \
        (True, True, 0.93, "cuda")
    for bad in (["--rescue_clusters", "maybe"], ["--mhnet_predictions_data_root", d + "/absent"]):
        with pytest.raises(SystemExit):
            run_sfm.build_parser().parse_args(sfm + bad)


# The evaluation, analysis and plotting CLIs, and the fused scorer's (its
# --mesh_devices included): (port module, salve_tpu's click command, argv
# cases); PATH and FILE stand for an existing directory and file.
NEW_CLI_CASES = [
    ("test_fused", "run_test_fused",
     [["--hypotheses_save_root", "PATH", "--raw_dataset_dir", "PATH", "--depth_save_root", "d", "--ckpt_fpath", "FILE",
       "--serialization_save_dir", "s"],
      ["--hypotheses_save_root", "PATH", "--raw_dataset_dir", "PATH", "--depth_save_root", "d", "--ckpt_fpath", "FILE",
       "--serialization_save_dir", "s", "--mesh_devices", "2", "--no_warp_renders", "--building_id", "0001",
       "--batch_size", "16", "--num_layers", "18", "--append_pair_difference"]]),
    ("eval_floorplan", "run_eval_floorplan",
     [["--raw_dataset_dir", "PATH", "--mhnet_predictions_data_root", "PATH"],
      ["--raw_dataset_dir", "PATH", "--mhnet_predictions_data_root", "PATH", "--split", "val", "--viz_save_dir", "v"]]),
    ("evaluate_sfm_baseline", "run_evaluate_sfm_baseline",
     [["--raw_dataset_dir", "PATH", "--results_dir", "PATH", "--algorithm_name", "opensfm", "--save_dir", "s"],
      ["--raw_dataset_dir", "PATH", "--results_dir", "PATH", "--algorithm_name", "openmvg", "--save_dir", "s",
       "--visualize_3d"]]),
    ("sanity_check_gt_pose_graphs", "run_sanity_check_dataset_pose_graphs", [["--raw_dataset_dir", "PATH"]]),
    ("compute_average_zind_stats", "run_compute_average_zind_stats", [["--raw_dataset_dir", "PATH"]]),
    ("estimate_completion_percent", "run_estimate_completion_percent",
     [["--hypotheses_save_root", "PATH", "--bev_save_root", "PATH"]]),
    ("measure_acc_vs_overlap", "run_measure_acc_vs_overlap",
     [["--serialized_preds_json_dir", "PATH", "--hypotheses_save_root", "PATH", "--raw_dataset_dir", "PATH"]]),
    ("split_vanishing_angle_file", "run_split_vanishing_angle_file", [["--csv", "FILE", "--out_dir", "o"]]),
    ("analyze_predictions", "main",
     [["--preds_dir", "PATH"],
      ["--preds_dir", "PATH", "--thresholds", "0.5,0.9", "--output_json", "r.json", "--hypotheses_save_root", "PATH",
       "--raw_dataset_dir", "PATH", "--building_id", "0001", "--fp_threshold", "0.7"]]),
    ("execute_opensfm", "run_execute_opensfm",
     [["--raw_dataset_dir", "PATH", "--opensfm_repo_root", "PATH", "--output_dir", "o"],
      ["--raw_dataset_dir", "PATH", "--opensfm_repo_root", "PATH", "--output_dir", "o", "--overrides_fpath", "FILE",
       "--split", "train", "--building_id", "0001"]]),
    ("execute_openmvg", "run_execute_openmvg",
     [["--raw_dataset_dir", "PATH", "--openmvg_sfm_bin", "PATH", "--output_dir", "o"],
      ["--raw_dataset_dir", "PATH", "--openmvg_sfm_bin", "PATH", "--output_dir", "o", "--split", "val",
       "--building_id", "1210"]]),
    ("analyze_capture_order", "run_analyze_capture_order",
     [["--hypotheses_save_root", "PATH"], ["--hypotheses_save_root", "PATH", "--save_fpath", "h.png"]]),
    ("make_precision_recall_plots", "run_make_precision_recall_plots",
     [["--serialized_preds_json_dir", "PATH", "--model_name", "a"],
      ["--serialized_preds_json_dir", "PATH", "--model_name", "a", "--serialized_preds_json_dir", "PATH",
       "--model_name", "b", "--save_fpath", "pr.pdf"]]),
    ("visualize_loss_plot", "run_visualize_loss_plot",
     [["--train_results_fpath", "FILE"], ["--train_results_fpath", "FILE", "--save_fpath", "l.png"]]),
    ("vis_zind_annotated_floorplans", "run_vis_zind_annotated_floorplans",
     [["--raw_dataset_dir", "PATH"], ["--raw_dataset_dir", "PATH", "--save_dir", "s", "--building_id", "0001"]]),
    ("visualize_backprojected_depthmap", "run_visualize_backprojected_depthmap",
     [["--depth_fpath", "FILE", "--rgb_fpath", "FILE"],
      ["--depth_fpath", "FILE", "--rgb_fpath", "FILE", "--save_fpath", "b.png"]]),
    ("visualize_edge_classifications", "run_visualize_edge_classifications",
     [["--serialized_preds_json_dir", "PATH", "--hypotheses_save_root", "PATH", "--raw_dataset_dir", "PATH"],
      ["--serialized_preds_json_dir", "PATH", "--hypotheses_save_root", "PATH", "--raw_dataset_dir", "PATH",
       "--confidence_threshold", "0.5", "--save_dir", "m"]]),
    ("visualize_floorplans_side_by_side_baselines", "run_visualize_floorplans_side_by_side_baselines",
     [["--raw_dataset_dir", "PATH", "--results_dir", "PATH", "--algorithm_name", "openmvg", "--save_dir", "s"]]),
    ("visualize_inferred_layout_w_gt_poses", "run_visualize_inferred_layout_w_gt_poses",
     [["--raw_dataset_dir", "PATH", "--mhnet_predictions_data_root", "PATH", "--building_id", "0001"],
      ["--raw_dataset_dir", "PATH", "--mhnet_predictions_data_root", "PATH", "--building_id", "0001", "--save_dir",
       "v"]]),
]


# Flags the port's CLIs have and salve_tpu's do not, with their defaults:
# the fused scorer computes a floor's missing depth on the card, and scores
# a layout verifier from MHNet's layouts or from HorizonNet's boundaries.
PORT_ONLY_FLAGS = {"test_fused": {"hohonet_ckpt": None, "hohonet_input_hw": "512,1024", "horizonnet_ckpt": None,
                                  "modalities": ["ceiling_rgb_texture", "floor_rgb_texture"],
                                  "mhnet_predictions_data_root": None}}


@pytest.mark.parametrize("cli,command,cases", NEW_CLI_CASES, ids=[c[0] for c in NEW_CLI_CASES])
def test_evaluation_cli_flags_parse_as_the_click_clis(tmp_path, cli, command, cases):
    """Flag for flag: the same names, defaults, types and values as the click
    originals parse, and the same arguments refused."""
    import importlib

    f = tmp_path / "f.csv"
    f.write_text("")
    port = importlib.import_module(f"salve_tpu_torch.cli.{cli}")
    click_cmd = getattr(importlib.import_module(f"salve_tpu.cli.{cli}"), command)
    for case in cases:
        argv = [{"PATH": str(tmp_path), "FILE": str(f)}.get(a, a) for a in case]
        got = vars(port.build_parser().parse_args(argv))
        assert got.pop("device", "cuda") == "cuda"
        for flag, default in PORT_ONLY_FLAGS.get(cli, {}).items():
            assert got.pop(flag) == default
        # A repeated flag: argparse appends to a list, click gathers a tuple.
        got = {k: tuple(v) if isinstance(v, list) else v for k, v in got.items()}
        assert got == click_cmd.make_context(cli, list(argv)).params
        assert ("device" in vars(port.build_parser().parse_args(argv))) == (cli in CARD_CLIS)
    bad = list(argv)
    bad[1] = str(tmp_path / "absent")  # every CLI's first flag is a path that must exist
    with pytest.raises(SystemExit):
        port.build_parser().parse_args(bad)
    with pytest.raises(Exception, match="does not exist"):
        click_cmd.make_context(cli, bad)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        device_mod.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_mod.resolve_device("cuda")
    assert device_mod.resolve_device("cpu").type == "cpu"


def test_entry_points_raise_without_a_card(no_cuda, tmp_path):
    from salve_tpu_torch.cli.test_fused import score_building_fused
    from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet
    from salve_tpu_torch.pipeline.fused_inference import score_floor_hypotheses
    from salve_tpu_torch.training.config import TrainingConfig

    cfg = TrainingConfig(num_layers=18, compute_dtype="float32")
    model = EarlyFusionCEResnet(num_layers=18, compute_dtype="float32")
    depths = np.full((1, 32, 64), 2000, np.uint16)
    rgbs = np.zeros((1, 32, 64, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        score_floor_hypotheses(model, cfg, depths, rgbs, {0: 0}, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        score_building_fused("0000", str(tmp_path), str(tmp_path), str(tmp_path), model, cfg, str(tmp_path))


def test_mesh_entry_points_raise_without_a_card(no_cuda, tmp_path):
    """The mesh, its launcher, the scorer and train() take the card by
    default and raise without one; a mesh of more processes than the group
    holds says how to start them."""
    from salve_tpu_torch.parallel import launch, make_mesh
    from salve_tpu_torch.training.config import TrainingConfig
    from salve_tpu_torch.training.loop import train

    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        launch(print, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        train(TrainingConfig(num_layers=18, mesh_shape=(2,), data_root=str(tmp_path / "absent")))
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        train(TrainingConfig(num_layers=18, mesh_shape=(2,), data_root=str(tmp_path / "absent")), device="cpu")
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group, mesh.device.type) == (1, 0, None, "cpu")


def test_stage_a_entry_points_raise_without_a_card(no_cuda, tmp_path):
    """Stage A's batched product, the exporter and the RANSAC alignment take
    `device=None` as the card and raise without one, even on empty input."""
    from salve_tpu_torch.algorithms.pose_alignment import (
        align_poses_sim3_ignore_missing,
        ransac_align_poses_sim3_ignore_missing,
    )
    from salve_tpu_torch.geometry.poses import Pose3
    from salve_tpu_torch.hypotheses.batched import align_floor_pairs_batched
    from salve_tpu_torch.hypotheses.export import export_single_building_wdo_alignment_hypotheses

    poses = [Pose3(np.eye(3), np.array([float(i), 0.0, 0.0])) for i in range(6)]
    with pytest.raises(RuntimeError, match="CUDA"):
        align_floor_pairs_batched({}, [], use_inferred_wdos_layout=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        ransac_align_poses_sim3_ignore_missing(poses, poses)
    with pytest.raises(RuntimeError, match="CUDA"):
        align_poses_sim3_ignore_missing(poses, poses, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        export_single_building_wdo_alignment_hypotheses(
            str(tmp_path), "0000", str(tmp_path / "zind_data.json"), str(tmp_path), False)
    assert align_floor_pairs_batched({}, [], use_inferred_wdos_layout=True, device="cpu") == {}
    assert ransac_align_poses_sim3_ignore_missing(poses, poses, device="cpu")[1].s == pytest.approx(1.0)


def test_stage_d_entry_points_raise_without_a_card(no_cuda, tmp_path):
    """Stage D's LM, report, raster and `run_incremental_reconstruction`
    take `device=None` as the card and raise without one, even on empty
    input."""
    from salve_tpu_torch.algorithms.pose2_slam import execute_planar_slam, planar_slam
    from salve_tpu_torch.cli.run_sfm import run_incremental_reconstruction
    from salve_tpu_torch.common.floor_reconstruction_report import FloorReconstructionReport, rasterize_room
    from salve_tpu_torch.common.posegraph2d import PoseGraph2d

    empty = PoseGraph2d("0000", "floor_01", {}, 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        planar_slam([None], [], {}, [], True)
    with pytest.raises(RuntimeError, match="CUDA"):
        execute_planar_slam([], [None])
    with pytest.raises(RuntimeError, match="CUDA"):
        FloorReconstructionReport.from_est_floor_pose_graph(empty, empty)
    with pytest.raises(RuntimeError, match="CUDA"):
        rasterize_room(empty, 1.0, 10, 0.1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_incremental_reconstruction(str(tmp_path), str(tmp_path), str(tmp_path), "pose2_slam", 0.93, False,
                                       ["door"], None, plot_save_dir=str(tmp_path / "out"))
    assert planar_slam([None], [], {}, [], True, device="cpu") == ([None], {})
    assert not rasterize_room(empty, 1.0, 10, 0.1, device="cpu").any()


def test_stitching_entry_points_raise_without_a_card(no_cuda, tmp_path):
    """Room grouping, the stitch IoU and raster, and both stitching flows take
    `device=None` as the card and raise without one, even on empty input."""
    from salve_tpu_torch.algorithms.room_merging import group_panos_by_room
    from salve_tpu_torch.cli.stitch_floor_plan import stitch_building_layouts
    from salve_tpu_torch.common.posegraph2d import PoseGraph2d
    from salve_tpu_torch.ops.raster import points_in_polygon_grid
    from salve_tpu_torch.stitching import shape
    from salve_tpu_torch.stitching.cluster_stitching import stitch_clusters

    empty = PoseGraph2d("0000", "floor_01", {}, 1.0)
    ring = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    with pytest.raises(RuntimeError, match="CUDA"):
        group_panos_by_room(empty)
    with pytest.raises(RuntimeError, match="CUDA"):
        shape.group_panos_by_room({}, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        shape.iou_between_polygon_sets([], [])
    with pytest.raises(RuntimeError, match="CUDA"):
        shape.rasterize_polygons_union([ring])
    with pytest.raises(RuntimeError, match="CUDA"):
        stitch_clusters(str(tmp_path), str(tmp_path), str(tmp_path), str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA"):
        stitch_building_layouts("0000", str(tmp_path), str(tmp_path), str(tmp_path), str(tmp_path / "out"))
    assert group_panos_by_room(empty, device="cpu") == []
    assert shape.iou_between_polygon_sets([], [], device="cpu")["iou"] == 0.0
    # The raster runs where its polygon lies: on the CPU here.
    mask = points_in_polygon_grid(torch.as_tensor(ring), np.array([0.2, 0.9]), np.array([0.2, 0.9]))
    assert mask.tolist() == [[True, False], [False, False]]


def test_renderer_entry_points_raise_without_a_card(no_cuda, tmp_path):
    """The file-contract renderer and the layout rasters take `device=None`
    as the card and raise without one, even on empty input."""
    from salve_tpu_torch.rendering.dataset_renderer import render_building_floor_pairs, render_pairs
    from salve_tpu_torch.rendering.layout import rasterize_layout_batch, rasterize_single_layout

    d = str(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_building_floor_pairs(d, d, d, d, "0000", "floor_01")
    with pytest.raises(RuntimeError, match="CUDA"):
        render_pairs(d, d, d, d, None, ["rgb_texture"], building_id="0000")
    with pytest.raises(RuntimeError, match="CUDA"):
        rasterize_layout_batch([])
    with pytest.raises(RuntimeError, match="CUDA"):
        rasterize_single_layout(np.zeros((3, 2)), [])
    assert render_building_floor_pairs(d, d, d, d, "0000", "floor_01", device="cpu") == 0
    assert render_pairs(d, d, d, d, None, ["rgb_texture"], building_id="0000", device="cpu") == 0
    assert rasterize_layout_batch([], device="cpu").shape == (0, 501, 501, 3)


def test_training_entry_points_raise_without_a_card(no_cuda, tmp_path):
    """train(), evaluate() and both training CLIs take the card by default
    and raise without one, before they read any data."""
    from salve_tpu_torch.cli import test as test_cli
    from salve_tpu_torch.cli import train as train_cli
    from salve_tpu_torch.training.config import TrainingConfig
    from salve_tpu_torch.training.loop import evaluate, train

    cfg = TrainingConfig(num_layers=18, data_root=str(tmp_path / "absent"))
    with pytest.raises(RuntimeError, match="CUDA"):
        train(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate(cfg, str(tmp_path / "ckpt.pt"), "test", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--data_root", str(tmp_path), "--model_save_dirpath", str(tmp_path / "m")])
    ckpt = tmp_path / "ckpt.pt"
    ckpt.write_bytes(b"")
    with pytest.raises(RuntimeError, match="CUDA"):
        test_cli.main(["--ckpt_fpath", str(ckpt), "--serialization_save_dir", str(tmp_path / "p")])
    assert not (tmp_path / "m").exists() and not (tmp_path / "p").exists()
    with pytest.raises(RuntimeError, match="absent"):
        train(cfg, device="cpu")


def test_depth_entry_points_raise_without_a_card(no_cuda, tmp_path):
    """The depth providers, the depth train state and both depth CLIs take
    the card by default and raise without one, before they read any file."""
    from salve_tpu_torch.cli import batch_hohonet_inference, train_depth
    from salve_tpu_torch.models.depth_net import load_depth_provider
    from salve_tpu_torch.models.hohonet import load_hohonet_depth_provider
    from salve_tpu_torch.training.depth import create_depth_train_state

    absent = str(tmp_path / "absent.pth")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_hohonet_depth_provider(absent)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_depth_provider(absent)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_depth_train_state(torch.Generator().manual_seed(0), num_layers=18)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_depth.main(["--raw_dataset_dir", str(tmp_path), "--model_save_fpath", str(tmp_path / "m" / "d.pt")])
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_hohonet_inference.main(["--raw_dataset_dir", str(tmp_path), "--depth_save_root", str(tmp_path / "d"),
                                      "--building_id", "0000"])
    assert not (tmp_path / "m").exists() and not (tmp_path / "d").exists()
    with pytest.raises(FileNotFoundError):
        load_hohonet_depth_provider(absent, device="cpu")


def test_end_to_end_and_icp_entry_points_raise_without_a_card(no_cuda, tmp_path):
    """The end-to-end harness, the ICP baseline and its CLI, the z-order and
    interpolation helpers take the card by default and raise without one,
    before they read or write any file; on the CPU they launch nothing."""
    from salve_tpu_torch.baselines import icp
    from salve_tpu_torch.cli import end_to_end_eval, register_depth_maps_icp
    from salve_tpu_torch.utils import interpolation_utils, zorder_utils

    d = tmp_path / "absent"
    f = tmp_path / "f.png"
    f.write_bytes(b"")
    cloud = np.random.default_rng(0).uniform(0, 1, (64, 6))
    xs = np.arange(8)
    pts = np.array([[0.0, 0.0], [3.0, 1.0], [1.0, 4.0], [5.0, 5.0]])
    calls = [
        lambda: end_to_end_eval.main(["--src_zind_dir", str(tmp_path), "--output_dir", str(d / "e2e")]),
        lambda: register_depth_maps_icp.main(["--depth_fpath_1", str(f), "--rgb_fpath_1", str(f),
                                              "--depth_fpath_2", str(f), "--rgb_fpath_2", str(f),
                                              "--save_fpath", str(d / "T.npy")]),
        lambda: register_depth_maps_icp.backproject_pano(str(f), str(f)),
        lambda: icp.register_colored_point_clouds(cloud, cloud),
        lambda: icp.register_point_clouds(cloud[:, :3], cloud[:, :3]),
        lambda: zorder_utils.choose_elevated_repeated_vals(xs, xs, xs * 0.1),
        lambda: interpolation_utils.interp_dense_grid_from_sparse(np.zeros((8, 8, 3), np.uint8), pts, pts, 8, 8,
                                                                  True),
        lambda: interpolation_utils.remove_hallucinated_content(np.zeros((8, 8, 3), np.uint8),
                                                                np.zeros((8, 8, 3), np.uint8)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not d.exists()
    device_mod.reset_launch_counts()
    assert zorder_utils.choose_elevated_repeated_vals(xs, xs, xs * 0.1, device="cpu").all()
    assert icp.register_point_clouds(cloud[:, :3], cloud[:, :3], device="cpu").shape == (4, 4)
    assert device_mod.launch_counts() == {"splat": 0, "fill": 0, "warp": 0, "layout": 0}


def test_evaluation_entry_points_raise_without_a_card(no_cuda, tmp_path):
    """The oracle-pose floorplan evaluation, the SfM baselines' evaluation and
    its CLI take the card by default and raise without one, before they read
    or write any file; on the CPU they run and launch nothing."""
    from salve_tpu_torch.baselines.sfm_eval import measure_algorithm_localization_accuracy
    from salve_tpu_torch.cli import eval_floorplan, evaluate_sfm_baseline

    d, out = str(tmp_path), tmp_path / "out"
    calls = [
        lambda: eval_floorplan.main(["--raw_dataset_dir", d, "--mhnet_predictions_data_root", d, "--viz_save_dir",
                                     str(out / "viz")]),
        lambda: eval_floorplan.eval_oraclepose_predictedlayout(d, d, "test", str(out / "viz")),
        lambda: evaluate_sfm_baseline.main(["--raw_dataset_dir", d, "--results_dir", d, "--algorithm_name", "opensfm",
                                            "--save_dir", str(out / "sfm")]),
        lambda: measure_algorithm_localization_accuracy("0000", "floor_01", d, "opensfm", str(out / "sfm"),
                                                        str(tmp_path / "absent.json")),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not out.exists()
    device_mod.reset_launch_counts()
    assert eval_floorplan.eval_oraclepose_predictedlayout(d, d, "test", str(out / "viz"), device="cpu") == []
    report = measure_algorithm_localization_accuracy("0000", "floor_01", d, "opensfm", str(out / "sfm"),
                                                     str(tmp_path / "absent.json"), device="cpu")
    assert report.percent_panos_localized == 0
    assert device_mod.launch_counts() == {"splat": 0, "fill": 0, "warp": 0, "layout": 0}


def test_native_readers_build_apart_from_the_kernels():
    """Each C file is its own library, outside libsalve_kernels.so, and links
    no library: the JPEG codec is written by hand, so no build in the port
    passes -ljpeg and nothing there includes a JPEG library's header."""
    import re

    from salve_tpu_torch.native import build

    jpeg_lib = build.library_path("jpeg_codec.c")
    png_lib = build.library_path("png_unfilter.c")
    assert jpeg_lib.parent != png_lib.parent and "libsalve_kernels" not in (jpeg_lib.name + png_lib.name)
    assert not list(kernels.CSRC.glob("*.c"))
    assert sorted(p.name for p in build.HERE.glob("*.c")) == ["jpeg_codec.c", "png_unfilter.c"]
    for src in ("jpeg_codec.c", "png_unfilter.c"):
        text = (build.HERE / src).read_text()
        assert "#include <torch" not in text
        assert not re.search(r"#include\s*[<\"](jpeglib|turbojpeg|jconfig|nvjpeg)", text), src
    py = [p for p in sorted((REPO / "salve_tpu_torch").rglob("*.py"))] + [REPO / "chip_smoke.py"]
    for f in py:
        assert "-ljpeg" not in f.read_text() and "-lturbojpeg" not in f.read_text(), f
    assert "-l" not in " ".join(build.CFLAGS)


def test_cuda_wrappers_reject_cpu_tensors():
    """The CUDA launchers never run a plain version: CPU input raises."""
    cell = torch.zeros((1, 4), dtype=torch.int32)
    ok = torch.ones((1, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        splat.splat_priority_grid_cuda(cell, cell, ok, 2, 2)
    sparse = torch.zeros((1, 4, 4, 3))
    occ = torch.zeros((1, 4, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        fill.fill_and_mask_cuda(sparse, occ, occ)
    bank = torch.zeros((1, 9, 9), dtype=torch.int32)
    p = warp.shear_warp_params(torch.eye(2)[None], torch.zeros((1, 2)), 9, 4, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        warp.shear_warp_cuda(bank, torch.zeros(1, dtype=torch.long), p)
    assert device_mod.launch_counts() == {"splat": 0, "fill": 0, "warp": 0, "layout": 0}


def test_cuda_wrappers_refuse_a_tensor_of_another_card(monkeypatch):
    """A CUDA tensor on a card other than the current one raises before any
    launch (the kernels launch into the current device's context). This
    build has no CUDA tensors: a stand-in on cuda:1 with cuda:0 current
    takes the check's path; chip_smoke.py's phase 13 runs the wrappers on
    the current card of each rank."""
    import types

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    other = types.SimpleNamespace(device=torch.device("cuda", 1), dtype=torch.int32, is_contiguous=lambda: True)
    with pytest.raises(ValueError, match="current device is cuda:0"):
        device_mod.require_cuda_tensor("cell", other, torch.int32)
    here = types.SimpleNamespace(device=torch.device("cuda", 0), dtype=torch.int32, is_contiguous=lambda: True)
    device_mod.require_cuda_tensor("cell", here, torch.int32)
    for wrapper in ("ops/splat.py", "ops/fill.py", "ops/warp.py", "rendering/layout.py"):
        text = (REPO / "salve_tpu_torch" / wrapper).read_text()
        assert "require_cuda_tensor(" in text and "kernels.stream_handle(" in text
        assert "kernels.stream_handle()" not in text  # the stream of the tensors' card


def test_dispatchers_raise_on_other_devices():
    cell = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        splat.splat_priority_grid(cell, cell, cell.bool(), 2, 2)
    sparse = torch.zeros((1, 4, 4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fill.fill_and_mask(sparse, sparse[..., 0].bool(), sparse[..., 0].bool())


def _layout_inputs(device="cpu"):
    """Two padded layouts (a square room and one with no W/D/O) as one
    upload's views, as `rendering/layout.py:rasterize_layout_batch` hands
    them to the raster."""
    verts = np.zeros((2, 5, 2), np.float32)
    verts[0, :4] = [(-1, -1), (1, -1), (1, 1), (-1, 1)]
    verts[1] = [(0, 0), (2, 0), (2, 1), (1, 2), (0, 1)]
    segs = np.zeros((2, 3, 2, 2), np.float32)
    segs[0, :2] = [[(-1, -1), (1, -1)], [(1, 1), (1, 1)]]
    colors = np.zeros((2, 3, 3), np.float32)
    colors[0, :2] = [(255, 0, 0), (0, 0, 255)]
    packed = layout_render.pack_layouts(verts, np.array([4, 5]), segs, colors, np.array([2, 0]))
    return layout_render.unpack_layouts(torch.as_tensor(packed, device=device), 5, 3)


def test_layout_dispatcher_raises_on_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        layout_render.rasterize_layout_batch_device(*_layout_inputs("meta"), 40, 0.1)


def test_layout_kernel_wrapper_rejects_cpu_tensors():
    """The layout kernel's launcher raises on CPU input (before it loads the
    kernels), and counts no launch."""
    device_mod.reset_launch_counts()
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        layout_render.rasterize_layout_cuda(*_layout_inputs(), 40, 0.1)
    assert "layout" in device_mod.KERNELS
    assert device_mod.launch_counts() == {"splat": 0, "fill": 0, "warp": 0, "layout": 0}


def test_layout_rasters_on_the_cpu_take_the_plain_version(monkeypatch):
    """On the CPU, `rasterize_layout_batch_device` is the plain version and
    launches nothing; the counts ride in the upload as int32 bits, and every
    input is a view of the one packed array."""
    def no_kernels():
        raise AssertionError("the CPU path loaded the kernels")

    monkeypatch.setattr(kernels, "load", no_kernels)
    inputs = _layout_inputs()
    verts, n_verts, segs, colors, n_wdos = inputs
    assert n_verts.tolist() == [4, 5] and n_wdos.tolist() == [2, 0] and n_verts.dtype == torch.int32
    assert len({t.untyped_storage().data_ptr() for t in inputs}) == 1
    assert verts.stride(0) == n_verts.stride(0) == 2 * 5 + 7 * 3 + 2 and verts[0].is_contiguous()
    device_mod.reset_launch_counts()
    got = layout_render.rasterize_layout_batch_device(*inputs, 40, 0.1)
    want = layout_render.rasterize_layout_plain(verts.contiguous(), torch.tensor([4, 5]), segs.contiguous(),
                                                colors.contiguous(), torch.tensor([2, 0]), 40, 0.1)
    assert got.dtype == torch.uint8 and got.shape == (2, 41, 41, 3) and torch.equal(got, want)
    assert (got[0] == 255).any() and (got[0, ..., 2] > got[0, ..., 1]).any() and (got[1] == 255).any()
    assert device_mod.launch_counts() == {"splat": 0, "fill": 0, "warp": 0, "layout": 0}


def test_layout_kernel_wrapper_takes_the_views_of_one_upload(monkeypatch):
    """The layout kernel reads one packed buffer, so its launcher takes
    `unpack_layouts`'s views of one upload and refuses copies or views of
    two uploads before it loads the kernels. This build has no CUDA tensors:
    CPU tensors stand in, with the device check passed."""
    class OnCard(torch.Tensor):
        device = property(lambda self: torch.device("cuda", 0))

    class Loaded(Exception):
        pass

    def load():
        raise Loaded

    real = device_mod.require_cuda_tensor
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(device_mod, "require_cuda_tensor", lambda name, t, dtype: real(name, t.as_subclass(OnCard),
                                                                                        dtype))
    monkeypatch.setattr(kernels, "load", load)
    inputs = _layout_inputs()
    with pytest.raises(Loaded):
        layout_render.rasterize_layout_cuda(*inputs, 40, 0.1)
    other = _layout_inputs()
    for args in ([t.clone() for t in inputs], (*inputs[:4], other[4]), (other[0], *inputs[1:])):
        with pytest.raises(ValueError, match="views of one packed upload"):
            layout_render.rasterize_layout_cuda(*args, 40, 0.1)


def test_cpu_only_build_has_no_kernels_and_chip_smoke_refuses(capsys):
    """On a build without CUDA the kernels cannot load and the smoke exits
    non-zero with no result line; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this build has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.load()
    import chip_smoke

    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_kernel_sources_are_hashed_and_present(tmp_path, monkeypatch):
    names = kernels.sources()
    assert {"splat.cu", "fill.cu", "warp.cu", "layout.cu"} <= set(names)
    for name in names:
        text = (kernels.CSRC / name).read_text()
        # A kernel names the Pallas kernel it replaces, or says it replaces
        # none and names the plain salve_tpu code it stands in for.
        replaces_none = "Replaces no Pallas kernel" in text and "salve_tpu/ops/" in text
        assert "Replaces salve_tpu/ops/pallas_" in text or replaces_none
        assert "What bounds it" in text
        assert 'extern "C"' in text
    assert "--use_fast_math" not in kernels.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert len(kernels._source_hash()) == 16

    # Every file under csrc/ is hashed, headers included, so editing a
    # shared header rebuilds instead of reusing a stale library.
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in names:
        (csrc / name).write_bytes((kernels.CSRC / name).read_bytes())
    monkeypatch.setattr(kernels, "CSRC", csrc)
    assert kernels.sources() == names
    base = kernels._source_hash()
    (csrc / "common.cuh").write_text("#pragma once\n")
    with_header = kernels._source_hash()
    assert with_header != base
    assert kernels.sources() == names  # a header is hashed, not compiled alone
    (csrc / "common.cuh").write_text("#pragma once\n// edited\n")
    assert kernels._source_hash() not in (base, with_header)
