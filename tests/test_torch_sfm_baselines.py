"""The port's SfM baselines held to salve_tpu's on the CPU.

  * the copies (`geometry/rotations3d.py`, `common/{posegraph3d,sfm_track}.py`,
    `baselines/sfm_reconstruction.py`, `utils/colormap.py`,
    `visualization/pose_viz.py`'s geometry) give the same bits and orders;
  * the OpenSfM and OpenMVG parsers give equal `Pose3`s, exactly, on
    `dataset/seeded_sfm.py`'s reconstructions of procedural floors and on the
    hand-written JSONs of `tests/baselines/test_baselines.py`;
  * `measure_algorithm_localization_accuracy` (the RANSAC Sim(3) and the
    report on the CPU) and `evaluate_sfm_baseline`: IoU and % localized
    equal, errors within 1e-6 (the report's bound,
    `tests/test_torch_report.py`), the `result_summaries` JSON files equal
    byte for byte, the CLI's stdout and `analyze_algorithm_results` equal;
    the aligned errors stay at the injected noise's level;
  * `execute_opensfm` / `execute_openmvg` build the same command lines as
    salve_tpu's, `run_command` recording instead of running on both sides;
  * `--visualize_3d` writes its two PNGs (matplotlib is here; the card's
    machine has none, and there the flag raises an ImportError naming it).
"""

import json
import sys

import numpy as np
import pytest

from salve_tpu.baselines import openmvg as jopenmvg
from salve_tpu.baselines import opensfm as jopensfm
from salve_tpu.baselines import sfm_eval as jsfm_eval
from salve_tpu.baselines.sfm_reconstruction import SfmReconstruction as JaxSfmReconstruction
from salve_tpu.cli import evaluate_sfm_baseline as jeval_cli
from salve_tpu.cli import execute_openmvg as jexec_openmvg
from salve_tpu.cli import execute_opensfm as jexec_opensfm
from salve_tpu.common import posegraph2d as jposegraph2d
from salve_tpu.common.posegraph3d import PoseGraph3d as JaxPoseGraph3d
from salve_tpu.common.sfm_track import SfmTrack2d as JaxSfmTrack2d
from salve_tpu.geometry import rotations3d as jrot
from salve_tpu.geometry.poses import Pose3 as JaxPose3
from salve_tpu.utils import colormap as jcolormap
from salve_tpu.visualization import pose_viz as jpose_viz
from salve_tpu_torch.baselines import openmvg, opensfm, sfm_eval
from salve_tpu_torch.baselines.sfm_reconstruction import SfmReconstruction
from salve_tpu_torch.cli import evaluate_sfm_baseline, execute_openmvg, execute_opensfm
from salve_tpu_torch.common import posegraph2d
from salve_tpu_torch.common.posegraph3d import PoseGraph3d
from salve_tpu_torch.common.sfm_track import SfmTrack2d
from salve_tpu_torch.dataset import seeded_sfm
from salve_tpu_torch.dataset.procedural import write_procedural_buildings
from salve_tpu_torch.geometry import rotations3d as rot
from salve_tpu_torch.geometry.poses import Pose3
from salve_tpu_torch.utils import colormap
from salve_tpu_torch.visualization import pose_viz
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# Procedural buildings: 0000 and 0001 are test-split ids for nothing here;
# the evaluation reads any directory of ZInD buildings.
BUILDINGS = ("0000", "0001")
ALGORITHMS = ("opensfm", "openmvg")
WRITERS = {"opensfm": seeded_sfm.write_opensfm_reconstruction, "openmvg": seeded_sfm.write_openmvg_reconstruction}
RECON = {"opensfm": "reconstruction.json", "openmvg": "reconstruction/sfm_data.json"}


@pytest.fixture(scope="module")
def sfm_tree(tmp_path_factory):
    """Procedural buildings and a seeded reconstruction of each floor by both
    algorithms, as `execute_opensfm` / `execute_openmvg` would leave them."""
    root = tmp_path_factory.mktemp("sfm")
    zind, results = root / "zind", root / "results"
    write_procedural_buildings(str(zind), list(BUILDINGS), base_seed=3)
    for bid in BUILDINGS:
        for alg in ALGORITHMS:
            WRITERS[alg](str(results), str(zind), bid, "floor_01", seed=int(bid) + 11)
    return zind, results


def _poses_equal(got, want) -> None:
    assert got.R.tobytes() == want.R.tobytes() and got.t.tobytes() == want.t.tobytes()


def _recons_equal(got, want) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g.pose_dict) == list(w.pose_dict)
        for i in g.pose_dict:
            _poses_equal(g.pose_dict[i], w.pose_dict[i])
        assert g.points.tobytes() == w.points.tobytes() and g.rgb.tobytes() == w.rgb.tobytes()
        assert vars(g.camera) == vars(w.camera) if g.camera is not None else w.camera is None
        assert [p is None for p in g.wTi_list] == [p is None for p in w.wTi_list]


# ---------------------------------------------------------------- the copies


def test_rotations3d_equal_salve_tpu():
    rng = np.random.default_rng(0)
    vecs = [rng.normal(0, 1, 3) for _ in range(20)] + [np.zeros(3), np.array([np.pi, 0, 0]), np.array([0, 1e-16, 0])]
    for r in vecs:
        R = rot.axis_angle_to_matrix(r)
        assert R.tobytes() == jrot.axis_angle_to_matrix(r).tobytes()
        assert rot.matrix_to_axis_angle(R).tobytes() == jrot.matrix_to_axis_angle(R).tobytes()
    for angles in rng.uniform(-np.pi, np.pi, (10, 3)):
        assert rot.rot3_rzryrx(*angles).tobytes() == jrot.rot3_rzryrx(*angles).tobytes()


def test_posegraph3d_project_to_2d_equals_salve_tpu(sfm_tree):
    zind, _ = sfm_tree
    gt = posegraph2d.get_gt_pose_graph("0000", "floor_01", str(zind))
    jgt = jposegraph2d.get_gt_pose_graph("0000", "floor_01", str(zind))
    rng = np.random.default_rng(1)
    wTi = [None if k in (1, 4) else Pose3(rot.axis_angle_to_matrix(rng.normal(0, 0.3, 3)), rng.normal(0, 2, 3))
           for k in range(len(gt.nodes) + 2)]  # two poses past the floor's panos are dropped
    jwTi = [None if p is None else JaxPose3(p.R, p.t) for p in wTi]
    got = PoseGraph3d.from_wTi_list(wTi, "0000", "floor_01").project_to_2d(gt)
    want = JaxPoseGraph3d.from_wTi_list(jwTi, "0000", "floor_01").project_to_2d(jgt)
    assert list(got.nodes) == list(want.nodes) and (got.building_id, got.floor_id) == (want.building_id, want.floor_id)
    assert got.scale_meters_per_coordinate == want.scale_meters_per_coordinate
    for i in got.nodes:
        g, w = got.nodes[i].global_Sim2_local, want.nodes[i].global_Sim2_local
        assert g.rotation.tobytes() == w.rotation.tobytes() and g.translation.tobytes() == w.translation.tobytes()
        assert g.scale == w.scale and got.nodes[i].image_path == want.nodes[i].image_path


def test_sfm_track_equals_salve_tpu():
    """Tracks of 8 landmarks over 5 panos (each pano sees a seeded subset,
    its keypoints in a seeded order), with one false match that joins two
    landmarks into an erroneous track (one pano twice), dropped on both sides."""
    rng = np.random.default_rng(2)
    keypoints = [rng.uniform(0, 10, (8, 2)) for _ in range(5)]
    seen = rng.uniform(size=(5, 8)) < 0.7
    kpt = [rng.permutation(8) for _ in range(5)]
    matches = {}
    for i1 in range(5):
        for i2 in range(i1 + 1, 5):
            both = np.flatnonzero(seen[i1] & seen[i2])
            matches[(i1, i2)] = np.stack([kpt[i1][both], kpt[i2][both]], axis=1)
    l0, l1 = np.flatnonzero(seen[0] & seen[1])[:2]
    matches[(0, 1)] = np.concatenate([matches[(0, 1)], [[kpt[0][l0], kpt[1][l1]]]])
    got = SfmTrack2d.generate_tracks_from_pairwise_matches(matches, keypoints)
    want = JaxSfmTrack2d.generate_tracks_from_pairwise_matches(matches, keypoints)
    assert 3 < len(got) == len(want) < 8
    for g, w in zip(got, want):
        assert [(m.i, m.uv.tobytes()) for m in g.measurements] == [(m.i, m.uv.tobytes()) for m in w.measurements]
        assert g.validate_unique_cameras() and w.validate_unique_cameras()
        assert g.number_measurements() == w.number_measurements() >= 2
        assert g.select_subset([0]) == g.select_subset([0]) != g.select_subset([1])
        assert g.measurement(1).uv.tobytes() == w.measurement(1).uv.tobytes()


def test_sfm_reconstruction_and_colormaps_equal_salve_tpu():
    poses = {3: Pose3(np.eye(3), np.ones(3)), 0: Pose3(np.eye(3), np.zeros(3))}
    got = SfmReconstruction(None, poses, np.zeros((0, 3)), np.zeros((0, 3), np.uint8)).wTi_list
    want = JaxSfmReconstruction(None, poses, np.zeros((0, 3)), np.zeros((0, 3), np.uint8)).wTi_list
    assert [p is None for p in got] == [p is None for p in want] == [False, True, True, False]
    for rgb in (True, False):
        assert colormap.get_tango_colormap(rgb).tobytes() == jcolormap.get_tango_colormap(rgb).tobytes()
    for n in (0, 1, 2, 7, 40):
        assert colormap.get_redgreen_colormap(n).tobytes() == jcolormap.get_redgreen_colormap(n).tobytes()
    wTi = [Pose3(rot.axis_angle_to_matrix([0.1 * k, 0.2, -0.1]), np.array([k, 2.0 * k, 0.5])) if k != 2 else None
           for k in range(5)]
    pts, rgb = pose_viz.get_colormapped_spheres(wTi)
    jpts, jrgb = jpose_viz.get_colormapped_spheres(wTi)
    assert pts.tobytes() == jpts.tobytes() and rgb.tobytes() == jrgb.tobytes()
    for g, w in zip(pose_viz.coordinate_frame_segments(wTi[3], 0.5), jpose_viz.coordinate_frame_segments(wTi[3], 0.5)):
        assert g.tobytes() == w.tobytes()


# ---------------------------------------------------------------- the parsers


@pytest.mark.parametrize("bid", BUILDINGS)
def test_parsers_on_seeded_reconstructions_equal_salve_tpu(sfm_tree, bid):
    _, results = sfm_tree
    f = results / f"ZinD_{bid}_floor_01__opensfm" / RECON["opensfm"]
    got = opensfm.load_opensfm_reconstructions_from_json(str(f))
    _recons_equal(got, jopensfm.load_opensfm_reconstructions_from_json(str(f)))
    assert len(got) == 2 and len(got[1].pose_dict) == 2 and got[0].points.shape == (seeded_sfm.NUM_POINTS, 3)
    f = results / f"ZinD_{bid}_floor_01__openmvg" / RECON["openmvg"]
    got = openmvg.load_openmvg_reconstructions_from_json(str(f), bid, "floor_01")
    _recons_equal(got, jopenmvg.load_openmvg_reconstructions_from_json(str(f), bid, "floor_01"))
    assert len(got) == 1 and got[0].camera is None


def test_parsers_on_hand_written_jsons_equal_salve_tpu(tmp_path):
    """The reconstruction JSONs written by hand in tests/baselines/test_baselines.py."""
    r, t = np.array([0.1, -0.2, 0.3]), [1.0, 2.0, 3.0]
    sfm = [{"cameras": {"cam0": {"projection_type": "spherical", "width": 2048, "height": 1024}},
            "shots": {"floor_01_partial_room_01_pano_7.jpg": {"rotation": r.tolist(), "translation": t}},
            "points": {"0": {"coordinates": [0, 1, 2], "color": [255, 0, 0]}}}]
    (tmp_path / "reconstruction.json").write_text(json.dumps(sfm))
    got = opensfm.load_opensfm_reconstructions_from_json(str(tmp_path / "reconstruction.json"))
    _recons_equal(got, jopensfm.load_opensfm_reconstructions_from_json(str(tmp_path / "reconstruction.json")))
    assert got[0].camera.projection_type == "SPHERICAL"
    assert opensfm.load_opensfm_reconstructions_from_json(str(tmp_path / "absent.json")) == []
    mvg = {"sfm_data_version": "0.3", "intrinsics": [],
           "views": [{"key": 0,
                      "value": {"ptr_wrapper": {"data": {"filename": "floor_01_partial_room_02_pano_4.jpg"}}}}],
           "extrinsics": [{"key": 0, "value": {"rotation": rot.rot3_rzryrx(0.1, 0.2, 0.3).tolist(),
                                               "center": [1.0, -1.0, 0.5]}}]}
    (tmp_path / "sfm_data.json").write_text(json.dumps(mvg))
    got = openmvg.load_openmvg_reconstructions_from_json(str(tmp_path / "sfm_data.json"), "0000", "floor_01")
    _recons_equal(got, jopenmvg.load_openmvg_reconstructions_from_json(str(tmp_path / "sfm_data.json"), "0000",
                                                                       "floor_01"))
    for i in (3, 4, 9):
        (tmp_path / f"floor_01_partial_room_01_pano_{i}.jpg").write_bytes(b"")
    assert openmvg.find_seed_pair(str(tmp_path)) == jopenmvg.find_seed_pair(str(tmp_path)) == (
        "floor_01_partial_room_01_pano_3.jpg", "floor_01_partial_room_01_pano_4.jpg")


# ---------------------------------------------------------------- the evaluation


def _reports_equal(got, want) -> None:
    assert got.percent_panos_localized == want.percent_panos_localized
    assert got.floorplan_iou == want.floorplan_iou
    for k in ("avg_abs_rot_err", "avg_abs_trans_err"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=0, atol=1e-6)


@pytest.mark.parametrize("alg", ALGORITHMS)
def test_measure_localization_accuracy_equals_salve_tpu(sfm_tree, tmp_path, alg):
    zind, results = sfm_tree
    for bid in BUILDINGS:
        f = str(results / f"ZinD_{bid}_floor_01__{alg}" / RECON[alg])
        got = sfm_eval.measure_algorithm_localization_accuracy(bid, "floor_01", str(zind), alg, str(tmp_path / "port"),
                                                               f, device="cpu")
        want = jsfm_eval.measure_algorithm_localization_accuracy(bid, "floor_01", str(zind), alg, str(tmp_path / "ref"),
                                                                 f)
        _reports_equal(got, want)
        assert 50.0 < got.percent_panos_localized < 100.0 and got.floorplan_iou > 0.3
        # The aligned errors are at the level of the injected noise: 1 degree
        # and 5 cm a pano (seeded_sfm), bounded here by 3x and 5x.
        assert got.avg_abs_rot_err < 3 * seeded_sfm.ROT_NOISE_DEG
        assert got.avg_abs_trans_err < 5 * seeded_sfm.TRANS_NOISE_M
        name = f"result_summaries/{bid}_floor_01.json"
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
    assert sfm_eval.analyze_algorithm_results(str(zind), str(tmp_path / "port" / "result_summaries")) == \
        jsfm_eval.analyze_algorithm_results(str(zind), str(tmp_path / "ref" / "result_summaries"))


def test_empty_reconstructions_and_unknown_algorithms(tmp_path):
    """No OpenSfM file, or an OpenMVG file with no extrinsics: the empty
    report on both sides; an unknown algorithm raises."""
    mvg = tmp_path / "sfm_data.json"
    mvg.write_text(json.dumps({"sfm_data_version": "0.3", "views": [], "extrinsics": []}))
    for alg, f in (("opensfm", tmp_path / "absent.json"), ("openmvg", mvg)):
        got = sfm_eval.measure_algorithm_localization_accuracy("0000", "floor_01", str(tmp_path), alg, str(tmp_path),
                                                               str(f), device="cpu")
        want = jsfm_eval.measure_algorithm_localization_accuracy("0000", "floor_01", str(tmp_path), alg,
                                                                 str(tmp_path), str(f))
        assert (got.percent_panos_localized, got.floorplan_iou) == (want.percent_panos_localized,
                                                                    want.floorplan_iou) == (0, 0.0)
        assert np.isnan(got.avg_abs_rot_err) and np.isnan(want.avg_abs_rot_err)
    with pytest.raises(ValueError, match="Unknown algorithm"):
        sfm_eval.measure_algorithm_localization_accuracy("0000", "floor_01", str(tmp_path), "colmap", str(tmp_path),
                                                         "x.json", device="cpu")


@pytest.mark.parametrize("alg", ALGORITHMS)
def test_evaluate_sfm_baseline_cli_equals_salve_tpu(sfm_tree, tmp_path, capsys, alg):
    zind, results = sfm_tree
    argv = ["--raw_dataset_dir", str(zind), "--results_dir", str(results), "--algorithm_name", alg]
    reports = evaluate_sfm_baseline.main(argv + ["--save_dir", str(tmp_path / "port"), "--device", "cpu"])
    got = capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        jeval_cli.run_evaluate_sfm_baseline.main(argv + ["--save_dir", str(tmp_path / "ref")],
                                                 standalone_mode=True)
    assert e.value.code == 0
    want = capsys.readouterr().out
    assert got == want and "mean_floorplan_iou" in got and "'num_floors': 2" in got
    assert len(reports) == len(BUILDINGS)
    for bid in BUILDINGS:
        name = f"result_summaries/{bid}_floor_01.json"
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()


def test_visualize_3d_writes_both_pngs(sfm_tree, tmp_path, monkeypatch):
    """With matplotlib (here) the flag writes the before/after renders; without
    it (the card's machine) it raises an ImportError that names matplotlib."""
    pytest.importorskip("matplotlib")
    zind, results = sfm_tree
    f = str(results / "ZinD_0001_floor_01__opensfm" / RECON["opensfm"])
    sfm_eval.measure_algorithm_localization_accuracy("0001", "floor_01", str(zind), "opensfm", str(tmp_path), f,
                                                     visualize_3d=True, device="cpu")
    pngs = sorted(p.name for p in (tmp_path / "viz_3d_poses").iterdir())
    assert pngs == ["0001_floor_01_aligned.png", "0001_floor_01_prealign.png"]
    assert all((tmp_path / "viz_3d_poses" / p).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" for p in pngs)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        sfm_eval.measure_algorithm_localization_accuracy("0001", "floor_01", str(zind), "opensfm",
                                                         str(tmp_path / "again"), f, visualize_3d=True, device="cpu")


# ---------------------------------------------------------------- the execute CLIs


def _pano_tree(root):
    """Two buildings' pano JPEG names (empty files): 0000 has two floors, the
    second with a single pano (no seed pair for OpenMVG)."""
    names = {"0000": ["floor_01_partial_room_01_pano_3.jpg", "floor_01_partial_room_02_pano_4.jpg",
                      "floor_01_partial_room_02_pano_9.jpg", "floor_02_partial_room_05_pano_12.jpg"],
             "0001": ["floor_01_partial_room_00_pano_0.jpg", "floor_01_partial_room_00_pano_1.jpg"]}
    for bid, files in names.items():
        (root / bid / "panos").mkdir(parents=True)
        for n in files:
            (root / bid / "panos" / n).write_bytes(b"")


@pytest.mark.parametrize("which", ["opensfm", "openmvg"])
def test_execute_cli_commands_equal_salve_tpu(tmp_path, capsys, monkeypatch, which):
    zind = tmp_path / "zind"
    _pano_tree(zind)
    tool = tmp_path / "tool"
    tool.mkdir()
    port, ref = {"opensfm": (execute_opensfm, jexec_opensfm), "openmvg": (execute_openmvg, jexec_openmvg)}[which]
    calls = {"port": [], "ref": []}
    monkeypatch.setattr(port, "run_command", lambda cmd, return_output=False: calls["port"].append(cmd))
    monkeypatch.setattr(ref, "run_command", lambda cmd, return_output=False: calls["ref"].append(cmd))
    flag = "--opensfm_repo_root" if which == "opensfm" else "--openmvg_sfm_bin"
    for bid in ("0000", "0001"):
        base = ["--raw_dataset_dir", str(zind), flag, str(tool), "--building_id", bid]
        port.main(base + ["--output_dir", str(tmp_path / "out")])
        got = capsys.readouterr().out
        cmd = ref.run_execute_opensfm if which == "opensfm" else ref.run_execute_openmvg
        with pytest.raises(SystemExit) as e:
            cmd.main(base + ["--output_dir", str(tmp_path / "out")], standalone_mode=True)
        assert e.value.code == 0
        assert got == capsys.readouterr().out
    assert calls["port"] == calls["ref"] and len(calls["port"]) == {"opensfm": 3, "openmvg": 12}[which]
    images = sorted(p.name for p in (tmp_path / "out" / f"ZinD_0000_floor_01__{which}" / "images").iterdir())
    assert images == ["floor_01_partial_room_01_pano_3.jpg", "floor_01_partial_room_02_pano_4.jpg",
                      "floor_01_partial_room_02_pano_9.jpg"]
