"""The paper's inference chain through the port's CLIs against salve_tpu's, on the CPU.

One small procedural building (`write_floors` of tests/test_torch_depth_synthetic.py:
two rooms, four panos as 256x512 JPEGs ray-cast from their rooms) goes through
the chain the README gives, once through the port's CLIs and once through
salve_tpu's, each stage reading the files its own package's previous stage
wrote:

  1. `export_alignment_hypotheses --wdo_source ground_truth`: the hypothesis
     files equal byte for byte;
  2. `batch_hohonet_inference` with a seeded HoHoNet `.pth` at
     `--hohonet_input_hw 64,128`: the same PNG names, the u16 maps at most
     1 mm apart on at most 0.1% of the pixels (the bound of
     tests/test_torch_depth_hohonet.py: a float32 depth near a half
     millimetre rounds either way);
  3. `test_fused` (ResNet-18, resize 32 / crop 28, bf16 as the CLIs build
     it, warp renders on both sides: the CPU's default is direct renders)
     with a fresh verifier in the released `train_ckpt.pth` layout, which
     each package converts on load (the port through
     `models/weights.py:read_verifier_checkpoint`): the batch files name the
     same pairs with the same labels, y_hat equal, probabilities within 1e-3
     (tests/test_torch_fused_slice.py's bound);
  4. `run_incremental_reconstruction` in the frozen configuration (pose2_slam,
     cluster rescue, threshold 0.93, no axis alignment): equal reports,
     serialized poses equal to the bit;
  5. `stitch_building_layouts` on those poses and seeded layouts
     (`dataset/seeded_stitching.py`): the fused shapes equal to the bit.

The verifier's head is biased towards class 1, so that Stage D finds edges at
its 0.93 threshold and stitching has poses to fuse.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from salve_tpu.cli import batch_hohonet_inference as jhoho
from salve_tpu.cli import export_alignment_hypotheses as jexport
from salve_tpu.cli import run_sfm as jrun_sfm
from salve_tpu.cli import stitch_floor_plan as jstitch
from salve_tpu.cli import test_fused as jfused
from salve_tpu.depth import cache as jcache
from salve_tpu.stitching import shape as jshape
from salve_tpu_torch.cli import batch_hohonet_inference, export_alignment_hypotheses, run_sfm, stitch_floor_plan
from salve_tpu_torch.cli import test_fused
from salve_tpu_torch.dataset import seeded_stitching
from salve_tpu_torch.models import hohonet
from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet, init_flax_style
from salve_tpu_torch.native import png

from test_torch_bev_pairs import listing_sorted
from test_torch_depth_synthetic import write_floors
from test_torch_stage_d import WDO_TYPES
from test_torch_stitching import _capture, _rings_key
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BID = "0000"
HOHONET_HW = (64, 128)
VERIFIER = ["--num_layers", "18", "--resize_px", "32", "--crop_px", "28", "--use_warp_renders"]
# Added to the class-1 logit: the fresh verifier scores these pairs between
# 0.39 and 0.46 (most of them 0.3916, logit -0.442); shifted, Stage D's 0.93
# (logit 2.587) keeps the four above 0.405 (logit -0.384), each side of it
# more than 1.5e-3 away.
CLASS1_SHIFT = 3.0
PROB_TOL = 1e-3
FROZEN = dict(method="pose2_slam", confidence_threshold=0.93, allowed_wdo_types=WDO_TYPES, use_axis_alignment=False,
              predictions_data_root=None, rescue_clusters=True)
PACKAGES = ("port", "ref")


def _tree(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def _read_batches(preds: pathlib.Path) -> dict:
    out = {k: [] for k in ("y_hat", "y_true", "y_hat_probs", "fp0", "fp1")}
    for f in sorted(preds.glob("batch_*.json"), key=lambda f: int(f.stem.split("_")[1])):
        data = json.loads(f.read_text())
        for k in out:
            out[k] += data[k]
    return out


def _verifier_checkpoint(out: pathlib.Path) -> pathlib.Path:
    """A fresh ResNet-18 verifier, initialized as salve_tpu's Flax model is,
    in the layout of the released `train_ckpt.pth` files, which both
    packages read; its head biased."""
    model = init_flax_style(EarlyFusionCEResnet(num_layers=18), torch.Generator().manual_seed(0))
    sd = model.state_dict()
    sd["fc.bias"] = sd["fc.bias"] + torch.tensor([0.0, CLASS1_SHIFT])
    out.mkdir()
    torch.save({"state_dict": sd}, out / "train_ckpt.pth")
    return out / "train_ckpt.pth"


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Both packages' chains over one building; every stage's output, per package."""
    root = tmp_path_factory.mktemp("chain")
    zind = root / "zind"
    write_floors(zind, bids=(BID,), jpeg_hw=(256, 512))
    building = json.loads((zind / BID / "zind_data.json").read_text())
    hohonet_ckpt = root / "ep60_seeded.pth"
    torch.save({"state_dict": hohonet.seeded_hohonet(HOHONET_HW, seed=0).state_dict()}, hohonet_ckpt)
    verifier_ckpt = _verifier_checkpoint(root / "verifier")
    seeded_stitching.write_layout_predictions(root / "layouts", BID, building, 0)
    d = {pkg: root / pkg for pkg in PACKAGES}

    # 1. Hypotheses.
    hyp = ["--raw_dataset_dir", str(zind), "--wdo_source", "ground_truth", "--split", "test", "--building_id", BID,
           "--num_processes", "1"]
    export_alignment_hypotheses.main(hyp + ["--hypotheses_save_root", str(d["port"] / "hyp"), "--device", "cpu"])
    jexport.run_export_alignment_hypotheses.main(hyp + ["--hypotheses_save_root", str(d["ref"] / "hyp")],
                                                 standalone_mode=False)
    # 2. The depth cache.
    depth = ["--raw_dataset_dir", str(zind), "--building_id", BID, "--model_ckpt", str(hohonet_ckpt),
             "--hohonet_input_hw", ",".join(map(str, HOHONET_HW))]
    batch_hohonet_inference.main(depth + ["--depth_save_root", str(d["port"] / "depth"), "--device", "cpu"])
    try:
        jhoho.run_batch_hohonet_inference.main(depth + ["--depth_save_root", str(d["ref"] / "depth")],
                                               standalone_mode=False)
    finally:
        jcache.register_depth_model(None)
    # 3. Fused scoring, each package on its own hypotheses and depth.
    for pkg, main, extra in (("port", test_fused.main, ["--device", "cpu"]),
                             ("ref", lambda a: jfused.run_test_fused.main(a, standalone_mode=False), [])):
        main(["--hypotheses_save_root", str(d[pkg] / "hyp"), "--raw_dataset_dir", str(zind), "--depth_save_root",
              str(d[pkg] / "depth"), "--ckpt_fpath", str(verifier_ckpt), "--serialization_save_dir", str(d[pkg] / "preds"),
              *VERIFIER, *extra])
    # 4. Stage D. It thresholds the probabilities and ranks edges by them, so
    # a difference within PROB_TOL can flip or reorder an edge: both
    # packages read salve_tpu's batch files here. The port's Stage D on the
    # port's own files is test_port_stage_d_reads_the_ports_batch_files.
    kw = dict(hypotheses_save_root=str(d["ref"] / "hyp"), serialized_preds_json_dir=str(d["ref"] / "preds"),
              raw_dataset_dir=str(zind), **FROZEN)
    reports = {"port": run_sfm.run_incremental_reconstruction(plot_save_dir=str(d["port"] / "sfm"), device="cpu", **kw),
               "ref": listing_sorted(jrun_sfm.run_incremental_reconstruction)(plot_save_dir=str(d["ref"] / "sfm"), **kw)}
    # 5. Stitching, each package on its own Stage D's poses.
    ser = {pkg: str(d[pkg] / "sfm_serialized" / f"{BID}__floor_01.json") for pkg in PACKAGES}
    with pytest.MonkeyPatch.context() as mp:
        refined = _capture(mp, jshape, "refine_predicted_shape")
        jstitch.stitch_building_layouts(BID, str(root / "layouts"), str(zind), ser["ref"], str(d["ref"] / "stitched"))
    stitched = {"ref": refined[0][0], "port": stitch_floor_plan.stitch_building_layouts(
        BID, str(root / "layouts"), str(zind), ser["port"], str(d["port"] / "stitched"), device="cpu")[0]}
    return dict(root=root, zind=zind, dirs=d, reports=reports, stitched=stitched)


def test_hypothesis_files_equal(chain):
    port, ref = (_tree(chain["dirs"][pkg] / "hyp") for pkg in PACKAGES)
    assert sorted(port) == sorted(ref) and len(port) > 10
    assert port == ref


def test_depth_caches_within_a_millimetre(chain):
    port, ref = (_tree(chain["dirs"][pkg] / "depth") for pkg in PACKAGES)
    assert sorted(port) == sorted(ref) and len(port) == 4
    off, n = 0, 0
    for name in ref:
        a, b = (png.read_png(chain["dirs"][pkg] / "depth" / name).astype(np.int64) for pkg in PACKAGES)
        assert a.shape == b.shape == (512, 1024)
        assert np.abs(a - b).max() <= 1, name
        off, n = off + int((a != b).sum()), n + a.size
    assert off <= 1e-3 * n


def test_scores_within_the_fused_slices_bound(chain):
    port, ref = (_read_batches(chain["dirs"][pkg] / "preds") for pkg in PACKAGES)
    assert len(ref["y_hat"]) > 10
    assert [port[k] for k in ("fp0", "fp1", "y_true")] == [ref[k] for k in ("fp0", "fp1", "y_true")]
    assert port["y_hat"] == ref["y_hat"]
    np.testing.assert_allclose(port["y_hat_probs"], ref["y_hat_probs"], atol=PROB_TOL, rtol=0)
    # Stage D has edges to keep and edges to drop at its threshold.
    probs = np.where(np.array(ref["y_hat"]) == 1, ref["y_hat_probs"], 0.0)
    assert 0 < int(np.sum(probs >= FROZEN["confidence_threshold"])) < len(probs)


def test_stage_d_reports_and_poses_equal(chain):
    port, ref = chain["reports"]["port"], chain["reports"]["ref"]
    assert len(port) == len(ref) == 1
    p, r = port[0], ref[0]
    assert (p.building_id, p.floor_id) == (r.building_id, r.floor_id) == (BID, "floor_01")
    assert r.percent_panos_localized > 0
    for k in ("percent_panos_localized", "percent_in_top2_ccs", "percent_in_top3_ccs", "floorplan_iou",
              "avg_abs_rot_err", "avg_abs_trans_err"):
        assert getattr(p, k) == getattr(r, k), k
    a, b = (json.loads((chain["dirs"][pkg] / "sfm_serialized" / f"{BID}__floor_01.json").read_text())
            for pkg in PACKAGES)
    assert a == b


def test_stitched_shapes_equal(chain):
    port, ref = chain["stitched"]["port"], chain["stitched"]["ref"]
    assert _rings_key(port) == _rings_key(ref) and len(port) >= 1


def test_port_stage_d_reads_the_ports_batch_files(chain):
    """The handoff from the port's scorer to its Stage D: the port's own
    batch files give a report and poses for the floor."""
    d = chain["dirs"]["port"]
    reports = run_sfm.run_incremental_reconstruction(
        hypotheses_save_root=str(d / "hyp"), serialized_preds_json_dir=str(d / "preds"),
        raw_dataset_dir=str(chain["zind"]), plot_save_dir=str(d / "sfm_own"), device="cpu", **FROZEN)
    assert [(r.building_id, r.floor_id) for r in reports] == [(BID, "floor_01")]
    assert reports[0].percent_panos_localized > 0
    assert (d / "sfm_own_serialized" / f"{BID}__floor_01.json").is_file()
