"""The end-to-end accuracy harness (`cli/end_to_end_eval.py`) against
salve_tpu's, on the CPU.

Inputs: procedural buildings on a 1x2 grid (two rooms and a door, five
panos) under the harness's building ids, 0000 (train) and 1210 (eval), and
one val building: its zind_data.json is written where
`write_procedural_buildings` would write it, which that writer's resume
contract then keeps. Tolerances, each stated at its test:
  * the flags parse as the click CLI's (same names, defaults and values);
    `--num_epochs 0` without a checkpoint is a usage error (exit 2), and a
    missing `--src_zind_dir` fails at parse time, before it;
  * `_report_dict` and `_per_building_verifier` equal salve_tpu's;
  * `_calibrate_on_val_split` (the six configurations of
    `--freeze_method_on_val`; both sides sweep the shorter threshold grid
    (0.5, 0.93) to keep the run short) gives salve_tpu's summary, frozen
    threshold and flags from the same val predictions;
  * `--stage_d_only` writes salve_tpu's JSON, less `total_wallclock_s`;
  * one whole run: salve_tpu's CLI trains 1 epoch (ResNet-18, resize 32 /
    crop 28, batch 16, `--calibrate_on_val`). The port's CLI, with
    `--num_epochs 0 --finetune_ckpt` on salve_tpu's `train_ckpt.flax`,
    first in a fresh directory (its own materialized, hypothesis and BEV
    trees, which equal salve_tpu's: JPEG, JSON and BEV bytes, decoded
    depth arrays), then on a copy of salve_tpu's output (the trees reused
    untouched by the resume contract, the predictions its own): the
    verifier's class-1 probabilities within 5e-3 (both sides in bfloat16,
    the harness's default) and labels equal wherever salve_tpu's
    probability is clear of 0.5 by that much, precision, recall and mAcc
    equal, the calibration's frozen point equal, the reconstruction rows
    equal with pose errors within 1e-6.

salve_tpu's loop runs on one JAX device and reads pixels through the port's
decoder, as in tests/test_torch_training.py (its own loader would build
native/libjpeg_loader.so inside the checkout).
"""

import hashlib
import json
import shutil
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest

from salve_tpu.cli import end_to_end_eval as jcli
from salve_tpu.common import edge_classification as jedge_classification
from salve_tpu.common.floor_reconstruction_report import FloorReconstructionReport as JReport
from salve_tpu.dataset import bev_pairs as jbp
from salve_tpu_torch.cli import end_to_end_eval as tcli
from salve_tpu_torch.common.floor_reconstruction_report import FloorReconstructionReport as TReport
from salve_tpu_torch.dataset.procedural import generate_building_json
from salve_tpu_torch.dataset.zind_partition import DATASET_SPLITS
from salve_tpu_torch.native import png
from test_torch_bev_pairs import listing_sorted, listing_sorted_make_dataset
from test_torch_training import _decode_like_salve_tpu_native, _one_jax_device

TRAIN, EVAL = "0000", "1210"
VAL = [b for b in sorted(DATASET_SPLITS["val"]) if b not in (TRAIN, EVAL)][0]
RUN = ["--num_layers", "18", "--resize_px", "32", "--crop_px", "28", "--batch_size", "16",
       "--procedural_val_buildings", "1", "--calibrate_on_val"]
TREES = ("zind", "depth", "hypotheses", "bev")
# The harness's verifier runs in bfloat16 (TrainingConfig's default) on both
# sides, whose convolutions round differently: class-1 probabilities were
# measured up to 1.6e-3 apart, so 5e-3 (bf16 keeps 8 bits).
PROB_TOL = 5e-3
REPORT_KEYS = ["avg_abs_rot_err_deg", "avg_abs_trans_err", "building_id", "floor_id", "floorplan_iou",
               "percent_in_top2_ccs", "percent_in_top3_ccs", "percent_panos_localized"]


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e_zind")
    for bid, seed in ((TRAIN, 1), (EVAL, 2)):
        (root / bid).mkdir()
        (root / bid / "zind_data.json").write_text(json.dumps(generate_building_json(seed, n_rows=1, n_cols=2)))
    return root


def _prepare(out: Path) -> Path:
    """The small val building where write_procedural_buildings keeps it."""
    d = out / "procedural_zind" / VAL
    d.mkdir(parents=True, exist_ok=True)
    (d / "zind_data.json").write_text(json.dumps(generate_building_json(3, n_rows=1, n_cols=2)))
    return out


def _sorted_stage_d_listing(mp):
    """salve_tpu's Stage D reads the batch files in sorted order, as the port
    does (test_torch_bev_pairs.listing_sorted)."""
    get = jedge_classification.get_edge_classifications_from_serialized_preds
    mp.setattr(jedge_classification, "get_edge_classifications_from_serialized_preds", listing_sorted(get))


def _run_salve_tpu(argv):
    mp = pytest.MonkeyPatch()
    try:
        _one_jax_device(mp)
        mp.setattr(jbp.BEVPairDataset, "_load_tuples", _decode_like_salve_tpu_native)
        mp.setattr(jbp, "make_dataset", listing_sorted_make_dataset)
        _sorted_stage_d_listing(mp)
        jcli.run_end_to_end_eval.main(argv, standalone_mode=False)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def runs(src, tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e_runs")
    ref = _prepare(root / "ref")
    _run_salve_tpu(["--src_zind_dir", str(src), "--output_dir", str(ref), "--num_epochs", "1", *RUN])
    ckpt, = ref.glob("ckpts/*/train_ckpt.flax")
    eval_only = ["--src_zind_dir", str(src), "--num_epochs", "0", "--finetune_ckpt", str(ckpt), *RUN,
                 "--device", "cpu"]
    own = _prepare(root / "own")
    own_summary = tcli.main(["--output_dir", str(own), *eval_only])
    copy = root / "copy"
    shutil.copytree(ref, copy)
    shutil.rmtree(copy / "preds")
    for d in copy.glob("val_preds_*"):
        shutil.rmtree(d)
    (copy / "end_to_end_eval.json").unlink()
    before = {t: _hashes(copy / t) for t in TREES}
    copy_summary = tcli.main(["--output_dir", str(copy), *eval_only])
    ref_summary = json.loads((ref / "end_to_end_eval.json").read_text())
    return dict(ref=ref, own=own, copy=copy, before=before, ref_summary=ref_summary, own_summary=own_summary,
                copy_summary=copy_summary)


def _hashes(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_port_builds_salve_tpus_trees(runs):
    ref, own = runs["ref"], runs["own"]
    for tree in TREES:
        want, have = _hashes(ref / tree), _hashes(own / tree)
        assert sorted(have) == sorted(want), tree
        for name in want:
            if name.endswith(".png"):  # imageio's PNG bytes and the port's differ; the arrays do not
                np.testing.assert_array_equal(png.read_png(own / tree / name), imageio.imread(ref / tree / name))
            else:
                assert have[name] == want[name], f"{tree}/{name}"
    assert len(list((own / "bev").rglob("*.jpg"))) > 50


def _check_summary(got: dict, ref: dict, got_preds: Path, ref_preds: Path) -> None:
    assert sorted(got) == sorted(ref)
    assert sorted(got["verifier"]) == sorted(ref["verifier"])
    for f in sorted(p.name for p in ref_preds.glob("batch_*.json")):
        r, g = json.loads((ref_preds / f).read_text()), json.loads((got_preds / f).read_text())
        for k in ("fp0", "fp1"):  # the same renders, under each run's own output directory
            assert [fp.split("/bev/", 1)[1] for fp in g[k]] == [fp.split("/bev/", 1)[1] for fp in r[k]]
        assert g["y_true"] == r["y_true"]
        p_ref = np.where(np.array(r["y_hat"]) == 1, r["y_hat_probs"], 1 - np.array(r["y_hat_probs"]))
        p_got = np.where(np.array(g["y_hat"]) == 1, g["y_hat_probs"], 1 - np.array(g["y_hat_probs"]))
        np.testing.assert_allclose(p_got, p_ref, atol=PROB_TOL)
        clear = np.abs(p_ref - 0.5) > PROB_TOL
        np.testing.assert_array_equal(np.array(g["y_hat"])[clear], np.array(r["y_hat"])[clear])
    for k in ("precision", "recall", "mAcc"):
        assert got["verifier"][k] == pytest.approx(ref["verifier"][k], abs=1e-12), k
    for k in ("per_building", "num_layers", "modalities"):
        assert got["verifier"][k] == ref["verifier"][k], k
    for k in ("train_building", "eval_building", "eval_procedural_buildings", "depth", "method", "rescue_clusters",
              "glc", "rotfix", "warp_corpus"):
        assert got[k] == ref[k], k
    # The calibration is fit to each side's own val probabilities, so its
    # temperature and the thresholds it maps follow them; the frozen point
    # and every val reconstruction of the sweep are equal.
    cal_got, cal_ref = got["calibration"], ref["calibration"]
    assert sorted(cal_got) == sorted(cal_ref)
    for k in ("frozen_threshold_calibrated", "frozen_config", "frozen_flags", "selection_rule", "num_val_pairs"):
        assert cal_got[k] == cal_ref[k], k
    for k in ("temperature", "ece_raw", "ece_calibrated", "threshold_raw_equivalent", "frozen_threshold_raw",
              "val_mAcc_at_threshold", "threshold_calibrated"):
        assert cal_got[k] == pytest.approx(cal_ref[k], rel=1e-2, abs=PROB_TOL), k
    sweep_got, sweep_ref = cal_got["val_reconstruction_sweep"], cal_ref["val_reconstruction_sweep"]
    assert sorted(sweep_got) == sorted(sweep_ref)
    for name in sweep_ref:
        assert sorted(sweep_got[name]) == sorted(sweep_ref[name])
        for t, row in sweep_ref[name].items():
            assert sweep_got[name][t]["raw_equivalent"] == pytest.approx(row["raw_equivalent"], abs=PROB_TOL)
            for k in ("val_mean_iou", "val_mean_loc", "n_floors"):
                assert sweep_got[name][t][k] == row[k], (name, t, k)
    assert got["confidence_threshold"] == pytest.approx(ref["confidence_threshold"], abs=PROB_TOL)
    assert len(got["reconstruction"]) == len(ref["reconstruction"]) >= 1
    for g, r in zip(got["reconstruction"], ref["reconstruction"]):
        assert sorted(g) == REPORT_KEYS
        for k in REPORT_KEYS:
            if k.startswith("avg_abs"):
                assert (g[k] is None) == (r[k] is None) and (g[k] is None or abs(g[k] - r[k]) <= 1e-6), k
            else:
                assert g[k] == r[k], k
    assert sorted(got["reconstruction_summary"]) == sorted(ref["reconstruction_summary"])
    assert sorted(got["timings_s"]) == sorted(ref["timings_s"])


def test_eval_only_run_on_salve_tpus_output_matches(runs):
    """The copy: every tree reused untouched, the predictions the port's."""
    copy = runs["copy"]
    for tree in TREES:
        assert _hashes(copy / tree) == runs["before"][tree], tree
    got = runs["copy_summary"]
    assert got == json.loads((copy / "end_to_end_eval.json").read_text())
    _check_summary(got, runs["ref_summary"], copy / "preds", runs["ref"] / "preds")
    assert got["verifier"]["ckpt"].endswith("train_ckpt.flax")
    assert got["verifier"]["train_mAcc_history"] == [] and got["timings_s"]["stage_c_train_s"] == 0.0
    assert got["verifier"]["num_epochs"] == 0
    assert len(runs["ref_summary"]["verifier"]["train_mAcc_history"]) == 1


def test_eval_only_run_from_scratch_matches(runs):
    _check_summary(runs["own_summary"], runs["ref_summary"], runs["own"] / "preds", runs["ref"] / "preds")


def test_stage_d_only_equals_salve_tpus(runs, tmp_path):
    ref_dir = tmp_path / "ref"
    shutil.copytree(runs["ref"], ref_dir)
    argv = ["--output_dir", str(ref_dir), "--stage_d_only", "--confidence_threshold", "0.6", "--rescue_clusters"]
    _run_salve_tpu(["--src_zind_dir", str(tmp_path), *argv])
    name = "end_to_end_eval_stage_d_pose2_slam_conf0.6_rescue.json"
    ref = json.loads((ref_dir / name).read_text())
    (ref_dir / name).unlink()
    got = tcli.main(["--src_zind_dir", str(tmp_path), *argv, "--device", "cpu"])
    assert got == json.loads((ref_dir / name).read_text())
    ref.pop("total_wallclock_s"), got.pop("total_wallclock_s")
    assert ref["stage_d_only"] and got == ref


def test_calibrate_on_val_split_equals_salve_tpus(runs, tmp_path, monkeypatch):
    """From salve_tpu's val predictions of the whole run (the ckpt tag
    "none"), over the six configurations and a shorter threshold grid."""
    _sorted_stage_d_listing(monkeypatch)
    ref_out = runs["ref"]
    val_preds, = ref_out.glob("val_preds_*")
    for side in ("ref", "got"):
        shutil.copytree(val_preds, tmp_path / side / "val_preds_none")
    kw = dict(cfg=None, ckpt_fpath=None, hyp_root=ref_out / "hypotheses", raw_dir=ref_out / "zind",
              method="pose2_slam", threshold_grid=(0.5, 0.93), config_grid=tcli.FREEZE_CONFIG_GRID)
    ref = jcli._calibrate_on_val_split(out=tmp_path / "ref", plots_dir=tmp_path / "ref" / "plots", **kw)
    got = tcli._calibrate_on_val_split(out=tmp_path / "got", plots_dir=tmp_path / "got" / "plots", device="cpu", **kw)
    assert len(got) == len(ref) == 3
    assert got[0] == ref[0] and got[1] == ref[1] and got[2] == ref[2]
    assert sorted(got[0]["val_reconstruction_sweep"]) == [name for name, _ in sorted(tcli.FREEZE_CONFIG_GRID)]


def test_calibration_without_val_predictions_is_a_usage_error(tmp_path, monkeypatch):
    monkeypatch.setattr("salve_tpu_torch.training.loop.evaluate", lambda *a, **k: (0.0, 0.0, 0.0))
    with pytest.raises(tcli.UsageError, match="non-empty val split"):
        tcli._calibrate_on_val_split(None, None, tmp_path, tmp_path, tmp_path, tmp_path, "pose2_slam", device="cpu")


# ------------------------------------------------------------------ helpers and flags


def _write_batch(preds_dir: Path, idx: int, rows) -> None:
    d = {"y_hat": [], "y_true": [], "y_hat_probs": [], "fp0": [], "fp1": []}
    for bid, yh, yt in rows:
        fp = f"/x/bev/gt_alignment_approx/{bid}/pair_0___door_0_0_ceiling_rgb_floor_01_partial_room_01_pano_1.jpg"
        d["y_hat"].append(yh), d["y_true"].append(yt), d["y_hat_probs"].append(0.9)
        d["fp0"].append(fp), d["fp1"].append(fp)
    (preds_dir / f"batch_{idx}.json").write_text(json.dumps(d))


def test_per_building_verifier_equals_salve_tpus(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(3):
        _write_batch(tmp_path, i, [(str(rng.choice(["000A", "000B", "000C"])), int(rng.integers(2)),
                                    int(rng.integers(2))) for _ in range(40)])
    _write_batch(tmp_path, 3, [("000D", 0, 0), ("000D", 1, 0)])  # no positives: recall and mAcc None
    ref = jcli._per_building_verifier(tmp_path)
    assert tcli._per_building_verifier(tmp_path) == ref and ref["000D"]["recall"] is None
    assert tcli._per_building_verifier(tmp_path / "missing") == {} == jcli._per_building_verifier(tmp_path / "missing")


@pytest.mark.parametrize("vals", [(1.0, 0.2, 100.0, 0.9, 50.0, 75.0), (np.nan, None, 0.0, 0.0, np.inf, np.nan)])
def test_report_dict_equals_salve_tpus(vals):
    rot, trans, loc, iou, top2, top3 = vals
    kw = dict(avg_abs_rot_err=rot, avg_abs_trans_err=trans, percent_panos_localized=loc, floorplan_iou=iou,
              building_id="1210", floor_id="floor_01")
    r, t = JReport(**kw), TReport(**kw)
    r.percent_in_top2_ccs = t.percent_in_top2_ccs = top2
    r.percent_in_top3_ccs = t.percent_in_top3_ccs = top3
    assert tcli._report_dict(t) == jcli._report_dict(r)
    assert sorted(tcli._report_dict(t)) == REPORT_KEYS


FLAG_CASES = [
    [],
    ["--no_warp_corpus", "--modalities", "layout", "--modalities", "floor_rgb_texture", "--num_epochs", "3",
     "--glc", "--rotfix", "--freeze_method_on_val", "--depth_ckpt", "d.msgpack", "--decoded_cache_gb", "2.5"],
    ["--warp_corpus", "--photometric_augmentation", "--append_pair_difference", "--stage_d_only",
     "--procedural_val_pathological", "2", "--eval_procedural_buildings", "1", "--train_building", "1210",
     "--eval_building", "0000", "--confidence_threshold", "0.93", "--resume_ckpt", "c.flax"],
]


@pytest.mark.parametrize("argv", FLAG_CASES)
def test_flags_parse_as_the_click_clis(argv, tmp_path):
    argv = ["--src_zind_dir", str(tmp_path), "--output_dir", str(tmp_path / "o"), *argv]
    ref = jcli.run_end_to_end_eval.make_context("end_to_end_eval", list(argv)).params
    got = vars(tcli.build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    got["modalities"] = tuple(got["modalities"] or tcli.DEFAULT_MODALITIES)
    assert got == ref
    click_names = {p.name for p in jcli.run_end_to_end_eval.params}
    assert click_names == set(got)


def test_usage_errors_exit_2(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--src_zind_dir", str(tmp_path), "--output_dir", str(tmp_path / "o"), "--num_epochs", "0",
                   "--device", "cpu"])
    assert e.value.code == 2 and "eval-only" in capsys.readouterr().err
    # The default --src_zind_dir is checked at parse time, before the rest.
    with pytest.raises(SystemExit) as e:
        tcli.main(["--src_zind_dir", str(tmp_path / "absent"), "--output_dir", str(tmp_path / "o"),
                   "--num_epochs", "0"])
    assert e.value.code == 2 and "does not exist" in capsys.readouterr().err
    default = next(p.default for p in jcli.run_end_to_end_eval.params if p.name == "src_zind_dir")
    assert tcli.build_parser().get_default("src_zind_dir") == default
