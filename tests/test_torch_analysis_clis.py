"""The port's evaluation and analysis CLIs held to salve_tpu's on the CPU.

Each CLI runs on both sides with the same arguments; its stdout, and the
files it writes, must be equal. The inputs come from in-repo generators:
  * two procedural buildings of the train split (`dataset/procedural.py`),
    GT-mode hypotheses and seeded verifier predictions
    (`test_torch_stage_d.make_stage_d_inputs`: a harness-style tree of
    `batch_{i}.json` files and hypothesis JSONs), and seeded MHNet layout
    predictions (`dataset/seeded_predictions.py`);
  * a BEV tree of empty render files for some of the hypotheses;
  * a vanishing-angle CSV written from a seeded generator.

`eval_floorplan` runs the report (RANSAC Sim(3), raster IoU) on the CPU
here: its summary lines are equal, and each floor's report within the
report's bounds (IoU and % localized equal, errors within 1e-6).
"""

import json

import numpy as np
import pytest

from salve_tpu.cli import analyze_predictions as janalyze
from salve_tpu.cli import compute_average_zind_stats as jstats
from salve_tpu.cli import estimate_completion_percent as jcompletion
from salve_tpu.cli import eval_floorplan as jeval_floorplan
from salve_tpu.cli import measure_acc_vs_overlap as jacc_overlap
from salve_tpu.cli import sanity_check_gt_pose_graphs as jsanity
from salve_tpu.cli import split_vanishing_angle_file as jsplit
from salve_tpu_torch.cli import (
    analyze_predictions,
    compute_average_zind_stats,
    estimate_completion_percent,
    eval_floorplan,
    measure_acc_vs_overlap,
    sanity_check_gt_pose_graphs,
    split_vanishing_angle_file,
)
from salve_tpu_torch.dataset.seeded_predictions import write_seeded_mhnet_predictions

from test_torch_stage_d import make_stage_d_inputs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# Buildings 0000 and 0001 lie in the train split (dataset/zind_partition.json).
FLOORS = [(0, {"n_rows": 2, "n_cols": 2}), (1, {"n_rows": 1, "n_cols": 3})]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("analysis")
    inputs = make_stage_d_inputs(root, floors=FLOORS)
    for seed, _ in FLOORS:
        bid = f"{seed:04d}"
        building = json.loads((root / "zind" / bid / "zind_data.json").read_text())
        write_seeded_mhnet_predictions(root / "mhnet", bid, building, seed)
    # Renders for 3 of every 4 positive hypotheses and half the negatives,
    # 4 files each (ceiling and floor of both panos), as the corpus lays them out.
    rng = np.random.default_rng(5)
    for seed, _ in FLOORS:
        bid = f"{seed:04d}"
        for key, share in (("gt_alignment_approx", 0.75), ("incorrect_alignment", 0.5)):
            hyps = sorted((root / "hyp" / bid).glob(f"*/{key}/*.json"))
            d = root / "bev" / key / bid
            d.mkdir(parents=True)
            for k in range(int(share * len(hyps))):
                for n in range(4):
                    (d / f"pair_{k}_{n}.jpg").write_bytes(b"")
    inputs.update(root=root, mhnet=str(root / "mhnet"), bev=str(root / "bev"))
    return inputs


def _run_both(port_main, click_cmd, argv, capsys, port_argv=()):
    """stdout of the port's CLI and of salve_tpu's click command on `argv`."""
    port_main(list(argv) + list(port_argv))
    got = capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        click_cmd.main(list(argv), standalone_mode=True)
    assert e.value.code == 0
    return got, capsys.readouterr().out


def test_eval_floorplan_equals_salve_tpu(tree, tmp_path, capsys, monkeypatch):
    argv = ["--raw_dataset_dir", tree["raw"], "--mhnet_predictions_data_root", tree["mhnet"], "--split", "train"]
    reports = eval_floorplan.main(argv + ["--viz_save_dir", str(tmp_path / "port"), "--device", "cpu"])
    got = capsys.readouterr().out
    # salve_tpu's reports, as its click command computes them.
    want_reports = []
    evaluate = jeval_floorplan.eval_oraclepose_predictedlayout
    monkeypatch.setattr(jeval_floorplan, "eval_oraclepose_predictedlayout",
                        lambda *args: want_reports.extend(evaluate(*args)) or want_reports)
    got_ref, want = _run_both(lambda argv: None, jeval_floorplan.run_eval_floorplan,
                              argv + ["--viz_save_dir", str(tmp_path / "ref")], capsys)
    assert got_ref == "" and got == want and "mean_floorplan_iou" in got
    assert len(reports) == len(want_reports) == len(FLOORS)
    for g, w in zip(reports, want_reports):
        assert (g.building_id, g.floor_id) == (w.building_id, w.floor_id)
        assert g.percent_panos_localized == w.percent_panos_localized == 100.0
        # The seeded MHNet rooms are not traced from the true ones.
        assert g.floorplan_iou == w.floorplan_iou > 0.1
        for k in ("avg_abs_rot_err", "avg_abs_trans_err"):
            np.testing.assert_allclose(getattr(g, k), getattr(w, k), rtol=0, atol=1e-6)
    names = sorted(f.name for f in (tmp_path / "ref_serialized").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "port_serialized").iterdir()) and len(names) == len(FLOORS)
    for name in names:
        assert (tmp_path / "port_serialized" / name).read_bytes() == (tmp_path / "ref_serialized" / name).read_bytes()


def test_sanity_check_and_zind_stats_equal_salve_tpu(tree, tmp_path, capsys):
    # A building directory without annotations fails the sweep on both sides.
    zind = tmp_path / "zind"
    for seed, _ in FLOORS:
        (zind / f"{seed:04d}").mkdir(parents=True)
        (zind / f"{seed:04d}" / "zind_data.json").write_bytes(
            (tree["root"] / "zind" / f"{seed:04d}" / "zind_data.json").read_bytes())
    (zind / "0007").mkdir()
    argv = ["--raw_dataset_dir", str(zind)]
    got, want = _run_both(sanity_check_gt_pose_graphs.main, jsanity.run_sanity_check_dataset_pose_graphs, argv, capsys)
    assert got == want and "2 buildings OK, 1 failed." in got and "FAILED 0007" in got
    got, want = _run_both(compute_average_zind_stats.main, jstats.run_compute_average_zind_stats, argv, capsys)
    assert got == want and got.startswith("Buildings: 2\n")


def test_estimate_completion_percent_equals_salve_tpu(tree, capsys):
    argv = ["--hypotheses_save_root", tree["hyp"], "--bev_save_root", tree["bev"]]
    got, want = _run_both(estimate_completion_percent.main, jcompletion.run_estimate_completion_percent, argv, capsys)
    assert got == want and got.count("\n") == len(FLOORS) and "Building 0000 Pos. " in got


def test_measure_acc_vs_overlap_equals_salve_tpu(tree, capsys):
    argv = ["--serialized_preds_json_dir", tree["preds"], "--hypotheses_save_root", tree["hyp"],
            "--raw_dataset_dir", tree["raw"]]
    got, want = _run_both(measure_acc_vs_overlap.main, jacc_overlap.run_measure_acc_vs_overlap, argv, capsys)
    assert got == want and "overlap IoU [0.0,0.1): acc" in got


def test_split_vanishing_angle_file_equals_salve_tpu(tmp_path, capsys):
    rng = np.random.default_rng(7)
    rows = ["building,pano,degree"] + [f"{int(b)},floor_01_partial_room_0{int(r)}_pano_{k}.jpg,{float(a)!r}"
                                       for k, (b, r, a) in enumerate(zip(rng.integers(0, 5, 40), rng.integers(0, 9, 40),
                                                                        rng.uniform(-45, 45, 40)))]
    csv = tmp_path / "angles.csv"
    csv.write_text("\n".join(rows) + "\n")
    got, want = _run_both(lambda argv: split_vanishing_angle_file.main(argv[:2] + ["--out_dir", str(tmp_path / "p")]),
                          jsplit.run_split_vanishing_angle_file, ["--csv", str(csv), "--out_dir", str(tmp_path / "r")],
                          capsys)
    assert got == want and "buildings)." in got
    files = sorted(p.name for p in (tmp_path / "r").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "p").iterdir()) and len(files) >= 4
    for name in files:
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "r" / name).read_bytes()


@pytest.mark.parametrize("families", [False, True])
def test_analyze_predictions_equals_salve_tpu(tree, tmp_path, capsys, families):
    argv = ["--preds_dir", tree["preds"], "--thresholds", "0.5,0.8,0.93"]
    if families:
        argv += ["--hypotheses_save_root", tree["hyp"], "--raw_dataset_dir", tree["raw"], "--building_id", "0001",
                 "--fp_threshold", "0.6"]
    port = analyze_predictions.main(argv + ["--output_json", str(tmp_path / "port.json")])
    got = capsys.readouterr().out.replace(str(tmp_path / "port.json"), "OUT")
    with pytest.raises(SystemExit) as e:
        janalyze.main.main(argv + ["--output_json", str(tmp_path / "ref.json")], standalone_mode=True)
    assert e.value.code == 0
    want = capsys.readouterr().out.replace(str(tmp_path / "ref.json"), "OUT")
    assert got == want and "hyp recall" in got and "edges lost" in got
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert sorted(port) == (["floor_01"] if families else sorted(port))
    if families:
        assert "FPs at conf>=0.6" in got and port["floor_01"]["fp_families"]


def test_analyze_predictions_usage_error_exits_2(tree, capsys):
    argv = ["--preds_dir", tree["preds"], "--hypotheses_save_root", tree["hyp"]]
    with pytest.raises(SystemExit) as e:
        analyze_predictions.main(argv)
    assert e.value.code == 2 and "--hypotheses_save_root needs --raw_dataset_dir" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        janalyze.main.main(argv, standalone_mode=True)
    assert e.value.code == 2
