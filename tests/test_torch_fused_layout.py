"""The fused scorer's ceiling + floor RGB + layout verifier against the
file-contract path, on the CPU at small sizes with seeded weights.

The layout modality's file-contract renderer draws each pair's two layouts
with `rendering/layout.py:rasterize_room_layout_pair` (pano 1 moved into pano
2's frame, pano 2 as it is), and the verifier trains on those images. The
scorer draws pano 2's once a floor and pano 1's once a batch row; tolerance:
none, the u8 rasters are equal, for rooms of about 50 to 600 vertices (the
seeded MHNet law of dataset/seeded_predictions.py, RDP-simplified as
dataset/mhnet_prediction.py does). The six-image logits equal those of the
verifier fed the file-contract renders; the RGB verifier's are those of its
four images, with no layout drawn. `cli/test_fused.py --modalities ...
layout` scores a seeded building's floor from files, its layouts read from
MHNet predictions as the layout renderer reads them.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from salve_tpu_torch.common.alignment_hypothesis import AlignmentHypothesis
from salve_tpu_torch.common.pano_data import PanoData
from salve_tpu_torch.common.wdo import WDO
from salve_tpu_torch.geometry import pano_projection
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.geometry.simplify import rdp
from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet
from salve_tpu_torch.pipeline import fused_inference
from salve_tpu_torch.rendering import bev_pair, layout
from salve_tpu_torch.rendering.bev_pair import BEVRenderConfig
from salve_tpu_torch.training import transforms
from salve_tpu_torch.training.config import TrainingConfig
from salve_tpu_torch.utils import profiler
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RGB = ("ceiling_rgb_texture", "floor_rgb_texture")
LAYOUT = RGB + ("layout",)
SIZES = dict(resize_h=40, resize_w=40, train_h=32, train_w=32, compute_dtype="float32")
HW = (64, 128)
BATCH = 3
# (floor seed, (boundary amplitude px, boundary noise px) a pano): level-ish
# boundaries leave about 50 vertices after RDP, noisy ones about 600.
FLOORS = [(0, [(2, 0.0), (40, 2.0), (40, 0.6)]), (1, [(40, 2.0), (40, 2.0), (2, 0.0), (40, 1.0)]),
          (2, [(2, 0.0), (40, 0.3), (40, 2.0)])]
TYPES = {"door": "doors", "window": "windows", "opening": "openings"}


def seeded_pano(rng: np.random.Generator, pano_id: int, amplitude: float, noise: float) -> PanoData:
    """A pano whose layout follows the seeded MHNet law: a 1024-column floor
    boundary backprojected at camera height 1, rounded to whole rows and
    RDP-simplified at 0.02, and 0-3 spans of each W/D/O type on it."""
    u = np.linspace(0, 2 * np.pi, 1024)
    boundary = 330 + amplitude * np.sin(u * rng.integers(1, 4) + rng.uniform(0, 6)) + rng.normal(0, noise, 1024)
    px = np.stack([np.arange(1024), np.round(boundary)], axis=-1).astype(np.float64)
    room = rdp(pano_projection.pixel_to_worldmetric(px, image_width=1024, camera_height_m=1.0)[:, :2], 0.02)
    wdos = {t: [] for t in TYPES.values()}
    for kind, t in TYPES.items():
        for _ in range(rng.integers(0, 4)):
            s = rng.uniform(0.02, 0.9) * 1023
            e = min(s + rng.uniform(0.02, 0.08) * 1024, 1023)
            ends = pano_projection.pixel_to_worldmetric(
                np.array([[s, boundary[round(s)]], [e, boundary[round(e)]]]), image_width=1024, camera_height_m=1.0)
            wdos[t].append(WDO(Sim2.identity(), tuple(ends[0, :2]), tuple(ends[1, :2]), -np.nan, np.nan, t))
    return PanoData(id=pano_id, global_Sim2_local=Sim2.identity(), room_vertices_local_2d=room,
                    image_path=f"floor_01_partial_room_00_pano_{pano_id}.jpg", label="room", **wdos)


def seeded_floor(seed: int, shapes):
    """(panos, depths, rgbs, hypotheses) of a floor: bank row k is pano 10 + k."""
    rng = np.random.default_rng(seed)
    panos = [seeded_pano(rng, 10 + k, a, n) for k, (a, n) in enumerate(shapes)]
    depths = rng.uniform(1000, 4000, (len(panos), *HW)).astype(np.uint16)
    rgbs = rng.uniform(0, 1, (len(panos), *HW, 3)).astype(np.float32)
    hyps = []
    for k in range(BATCH + 2):  # a full batch and a padded one
        i1, i2 = rng.choice(len(panos), 2, replace=False)
        sim = Sim2.from_theta_deg(rng.uniform(-180, 180), rng.uniform(-2, 2, 2))
        hyps.append((10 + int(i1), 10 + int(i2), AlignmentHypothesis(
            i2Ti1=sim, wdo_alignment_object="door", i1_wdo_idx=k, i2_wdo_idx=0, configuration="identity")))
    return panos, depths, rgbs, hyps


def floor_layouts(panos):
    return [(p.room_vertices_local_2d, p.all_wdos) for p in panos]


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    return {m: EarlyFusionCEResnet(num_layers=18, modalities=m, compute_dtype="float32").eval() for m in (RGB, LAYOUT)}


def score(model, modalities, floor, render_cfg=BEVRenderConfig(), **kw):
    panos, depths, rgbs, hyps = floor
    rows = {p.id: k for k, p in enumerate(panos)}
    return fused_inference.score_floor_hypotheses(
        model, TrainingConfig(num_layers=18, modalities=modalities, **SIZES), depths, rgbs, rows, hyps,
        batch_size=BATCH, render_cfg=render_cfg, use_warp_renders=False, device="cpu", **kw)


def recording_rasters(monkeypatch):
    """Every `layout_rasters` output of the calls that follow, in order."""
    drawn = []
    real = fused_inference.layout_rasters

    def record(*a, **k):
        drawn.append(real(*a, **k))
        return drawn[-1]

    monkeypatch.setattr(fused_inference, "layout_rasters", record)
    return drawn


@pytest.mark.parametrize("seed,shapes", FLOORS, ids=[f"floor{s}" for s, _ in FLOORS])
def test_the_scorers_layout_rasters_equal_the_file_contract_renderers(models, monkeypatch, seed, shapes):
    floor = seeded_floor(seed, shapes)
    panos, _, _, hyps = floor
    counts = [len(p.room_vertices_local_2d) for p in panos]
    assert min(counts) <= 80 and max(counts) >= 500, counts
    drawn = recording_rasters(monkeypatch)
    score(models[LAYOUT], LAYOUT, floor, layouts=floor_layouts(panos))
    bank, batches = drawn[0], drawn[1:]
    assert bank.shape == (len(panos), 501, 501, 3) and bank.dtype == torch.uint8
    assert [b.shape[0] for b in batches] == [BATCH, BATCH]  # the padded batch too
    rows = torch.cat(batches)
    by_id = {p.id: p for p in panos}
    for k, (i1, i2, h) in enumerate(hyps):
        img1, img2 = layout.rasterize_room_layout_pair(h.i2Ti1, by_id[i1], by_id[i2], device="cpu")
        np.testing.assert_array_equal(rows[k].numpy(), img1)
        np.testing.assert_array_equal(bank[i2 - 10].numpy(), img2)
    assert (rows == 255).any() and (rows[..., 0] != rows[..., 1]).any()  # room fill and coloured lines


def file_contract_probs(model, floor, with_layout: bool) -> np.ndarray:
    """Probabilities of the predicted classes of the floor's hypotheses, the
    verifier fed the file-contract renders (the direct arm's ceiling and floor
    pairs, `rasterize_room_layout_pair`'s layouts) in the scorer's padded
    batches, in training's image order."""
    panos, depths, rgbs, hyps = floor
    by_id = {p.id: p for p in panos}
    depths_d, rgbs_d = torch.as_tensor(depths.astype(np.float32)), torch.as_tensor(rgbs)
    out = []
    for start in range(0, len(hyps), BATCH):
        chunk = hyps[start : start + BATCH]
        chunk = chunk + [chunk[-1]] * (BATCH - len(chunk))
        pairs = np.array([[i1 - 10, i2 - 10] for i1, i2, _ in chunk])
        rot = np.stack([h.i2Ti1.rotation for *_, h in chunk]).astype(np.float32)
        trans = np.stack([h.i2Ti1.translation for *_, h in chunk]).astype(np.float32)
        ceil = bev_pair.render_bev_pairs_batch_device(depths_d, rgbs_d, pairs, rot, trans, "ceiling", BEVRenderConfig())
        flr = bev_pair.render_bev_pairs_batch_device(depths_d, rgbs_d, pairs, rot, trans, "floor", BEVRenderConfig())
        images = [ceil[0], ceil[1], flr[0], flr[1]]
        if with_layout:
            pairs_l = [layout.rasterize_room_layout_pair(h.i2Ti1, by_id[i1], by_id[i2], device="cpu")
                       for i1, i2, h in chunk]
            images += [torch.as_tensor(np.stack([p[j] for p in pairs_l])) for j in (0, 1)]
        batch = transforms.resize_batch(torch.stack(images, dim=1), SIZES["resize_h"], SIZES["resize_w"])
        batch = transforms.preprocess_eval(batch, SIZES["train_h"], SIZES["train_w"])
        with torch.no_grad():
            probs = torch.softmax(model([batch[:, i].permute(0, 3, 1, 2) for i in range(batch.shape[1])]), dim=1)
        out.append(probs.max(dim=1).values.numpy())
    return np.concatenate(out)[: len(hyps)]


def test_the_six_image_logits_equal_the_verifier_fed_the_file_contract_renders(models):
    floor = seeded_floor(3, [(40, 2.0), (2, 0.0), (40, 1.0)])
    got = score(models[LAYOUT], LAYOUT, floor, layouts=floor_layouts(floor[0]))
    want = file_contract_probs(models[LAYOUT], floor, with_layout=True)
    np.testing.assert_array_equal(np.array([r.prob for r in got], dtype=np.float32), want)
    assert [(r.i1, r.i2) for r in got] == [(i1, i2) for i1, i2, _ in floor[3]]


def test_the_rgb_path_is_unchanged_and_draws_no_layout(models, monkeypatch):
    floor = seeded_floor(4, [(40, 2.0), (2, 0.0), (40, 1.0)])
    drawn = recording_rasters(monkeypatch)
    before = profiler.counter("layout/rasters")
    got = score(models[RGB], RGB, floor)
    assert drawn == [] and profiler.counter("layout/rasters") == before
    want = file_contract_probs(models[RGB], floor, with_layout=False)
    np.testing.assert_array_equal(np.array([r.prob for r in got], dtype=np.float32), want)


def test_a_floor_without_layouts_or_layouts_for_the_rgb_verifier_raise(models):
    floor = seeded_floor(5, [(2, 0.0), (2, 0.0), (2, 0.0)])
    with pytest.raises(ValueError, match="layouts"):
        score(models[LAYOUT], LAYOUT, floor)
    with pytest.raises(ValueError, match="layouts"):
        score(models[RGB], RGB, floor, layouts=floor_layouts(floor[0]))
    with pytest.raises(ValueError, match="2 layouts for a bank of 3"):
        score(models[LAYOUT], LAYOUT, floor, layouts=floor_layouts(floor[0])[:2])
    with pytest.raises(ValueError, match="with or without the layout"):
        score(models[LAYOUT], ("floor_rgb_texture", "layout"), floor, layouts=floor_layouts(floor[0]))


def test_the_layout_counters_count_what_is_drawn(models):
    floor = seeded_floor(6, [(2, 0.0), (40, 0.3), (2, 0.0)])
    panos, _, _, hyps = floor
    names = ("layout/rasters", "layout/vertices", "layout/wdos")
    before = {n: profiler.counter(n) for n in names}
    score(models[LAYOUT], LAYOUT, floor, BEVRenderConfig(img_px=100, meters_per_px=0.1), layouts=floor_layouts(panos))
    by_id = {p.id: p for p in panos}
    padded = hyps + [hyps[-1]] * (-len(hyps) % BATCH)
    drawn = list(panos) + [by_id[i1] for i1, _, _ in padded]
    assert profiler.counter("layout/rasters") - before["layout/rasters"] == len(drawn)
    assert profiler.counter("layout/vertices") - before["layout/vertices"] == sum(
        len(p.room_vertices_local_2d) for p in drawn)
    assert profiler.counter("layout/wdos") - before["layout/wdos"] == sum(len(p.all_wdos) for p in drawn)


def seeded_building(root: Path, building_id: str):
    """A procedural 1x2-room building with random JPEG panos, u16 depth PNGs,
    seeded MHNet predictions (one pano's left out) and four hypothesis files
    of floor_01, one of them on the pano without a prediction: (hypothesis
    root, raw dataset root, depth root, MHNet root, the left-out pano id)."""
    from salve_tpu_torch.dataset import procedural
    from salve_tpu_torch.dataset.seeded_predictions import pano_image_paths, write_seeded_mhnet_predictions
    from salve_tpu_torch.native import jpeg, png

    building = procedural.generate_building_json(5, n_rows=1, n_cols=2)
    raw, depth, mhnet, hyp = (root / d for d in ("raw", "depth", "mhnet", "hyp"))
    (raw / building_id).mkdir(parents=True)
    (raw / building_id / "zind_data.json").write_text(json.dumps(building))
    rng = np.random.default_rng(0)
    paths = pano_image_paths(building)
    for pid, rel in paths.items():
        img = raw / building_id / rel
        img.parent.mkdir(parents=True, exist_ok=True)
        jpeg.write_jpeg(img, rng.integers(0, 255, (64, 128, 3)).astype(np.uint8))
        d = depth / building_id / f"{Path(rel).stem}.depth.png"
        d.parent.mkdir(parents=True, exist_ok=True)
        d.write_bytes(png.encode_png(rng.integers(1000, 4000, (512, 1024)).astype(np.uint16)))
    write_seeded_mhnet_predictions(mhnet, building_id, building, 0)
    ids = sorted(paths)
    dropped = ids[-1]
    (mhnet / "horizon_net" / building_id / f"{Path(paths[dropped]).stem}.json").unlink()
    floor = hyp / building_id / "floor_01"
    for label, (i1, i2), th in (("gt_alignment_approx", ids[:2], 30.0), ("incorrect_alignment", ids[:2], 120.0),
                                ("incorrect_alignment", (ids[1], ids[2]), -45.0),
                                ("incorrect_alignment", (ids[0], dropped), 10.0)):
        (floor / label).mkdir(parents=True, exist_ok=True)
        Sim2.from_theta_deg(th, rng.uniform(-1, 1, 2)).save_as_json(str(floor / label / f"{i1}_{i2}__door_0_1_identity.json"))
    return hyp, raw, depth, mhnet, dropped


def test_the_cli_scores_a_seeded_buildings_floor_with_a_six_image_checkpoint(models, tmp_path):
    from salve_tpu_torch.cli import test_fused
    from salve_tpu_torch.dataset.hnet_prediction_loader import load_inferred_floor_pose_graphs

    building_id = "0998"
    hyp, raw, depth, mhnet, dropped = seeded_building(tmp_path, building_id)
    ckpt = tmp_path / "six_images.pt"
    torch.save({"model": models[LAYOUT].state_dict(), "opt_state": {}, "step": 0}, ckpt)
    argv = ["--hypotheses_save_root", str(hyp), "--raw_dataset_dir", str(raw), "--depth_save_root", str(depth),
            "--ckpt_fpath", str(ckpt), "--serialization_save_dir", str(tmp_path / "preds"), "--num_layers", "18",
            "--resize_px", str(SIZES["resize_h"]), "--crop_px", str(SIZES["train_h"]), "--batch_size", "2",
            "--device", "cpu", "--modalities", *LAYOUT]
    with pytest.raises(ValueError, match="MHNet"):
        test_fused.main(argv)
    test_fused.main(argv + ["--mhnet_predictions_data_root", str(mhnet)])
    got = {k: [] for k in ("y_hat", "y_hat_probs", "fp0", "y_true")}
    for f in sorted((tmp_path / "preds").glob("batch_*.json")):
        data = json.loads(f.read_text())
        for k in got:
            got[k] += data[k]
    # The hypothesis on the pano without a layout is skipped, as the layout renderer skips it.
    assert len(got["y_hat"]) == 3 and not any(f"_pano_{dropped}." in fp for fp in got["fp0"])
    assert got["y_true"] == [1, 0, 0]

    # The same floor through the scorer, its layouts the pose graph's.
    cfg = TrainingConfig(num_layers=18, modalities=LAYOUT, resize_h=SIZES["resize_h"], resize_w=SIZES["resize_w"],
                         train_h=SIZES["train_h"], train_w=SIZES["train_w"])
    nodes = load_inferred_floor_pose_graphs(building_id, str(raw), str(mhnet))["floor_01"].nodes
    hyps = []
    for label in ("gt_alignment_approx", "incorrect_alignment"):
        for f in sorted((hyp / building_id / "floor_01" / label).glob("*.json")):
            i1, i2 = (int(x) for x in f.stem.split("__")[0].split("_"))
            if dropped not in (i1, i2):
                hyps.append((i1, i2, AlignmentHypothesis(i2Ti1=Sim2.from_json(f), wdo_alignment_object="door",
                                                         i1_wdo_idx=0, i2_wdo_idx=1, configuration="identity")))
    ids = sorted({i for h in hyps for i in h[:2]})
    imgs = {int(p.stem.split("_")[-1]): p for p in (raw / building_id / "panos").glob("*.jpg")}
    depths = np.stack([bev_pair.load_depth_mm(str(depth / building_id / f"{imgs[i].stem}.depth.png")) for i in ids])
    rgbs = np.stack([bev_pair.load_pano_rgb(str(imgs[i])) for i in ids]).astype(np.float32)
    want = fused_inference.score_floor_hypotheses(
        test_fused.load_verifier(str(ckpt), cfg), cfg, depths, rgbs, {i: k for k, i in enumerate(ids)}, hyps,
        batch_size=2, device="cpu", layouts=[(nodes[i].room_vertices_local_2d, nodes[i].all_wdos) for i in ids])
    assert got["y_hat"] == [r.y_hat for r in want]
    assert got["y_hat_probs"] == [r.prob for r in want]
