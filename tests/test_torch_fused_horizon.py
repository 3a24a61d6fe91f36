"""The fused scorer's HorizonNet path against its layouts path, on the CPU at
small sizes with seeded weights.

`score_floor_hypotheses(layout_model=..., wdo_spans=...)` computes each
pano's floor boundary (models/horizonnet.py) and makes each pano's room and
W/D/Os from it as MHNet's parser does (dataset/mhnet_prediction.py). Fed
the parser's own layouts of the same boundaries and spans, the layouts
path must draw the same rasters, byte for byte, and give the same answers;
the RGB and layouts paths take no `horizon` or `boundary` span.
`cli/test_fused.py --horizonnet_ckpt` scores a seeded building's floor with
the W/D/Os of its MHNet predictions and the boundaries of the checkpoint.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.horizonnet_weights import make_state_dict, scale_output
from salve_tpu_torch.common.alignment_hypothesis import AlignmentHypothesis
from salve_tpu_torch.dataset.mhnet_prediction import MHNetDWO, MHNetPanoStructurePrediction
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet
from salve_tpu_torch.models import horizonnet
from salve_tpu_torch.models.horizonnet import HorizonNet
from salve_tpu_torch.pipeline import fused_inference
from salve_tpu_torch.rendering.bev_pair import BEVRenderConfig
from salve_tpu_torch.training.config import TrainingConfig
from salve_tpu_torch.utils import profiler
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RGB = ("ceiling_rgb_texture", "floor_rgb_texture")
LAYOUT = RGB + ("layout",)
SIZES = dict(resize_h=40, resize_w=40, train_h=32, train_w=32, compute_dtype="float32")
HW = (64, 128)
BATCH = 3
RENDER = BEVRenderConfig(img_px=100, meters_per_px=0.1)


@pytest.fixture(scope="module")
def nets():
    torch.manual_seed(0)
    horizon = HorizonNet(HW).eval()
    # The output layer scaled so the boundaries keep to rows 36-42 of 64.
    horizon.load_state_dict(scale_output(make_state_dict(7, "cpu", HW), 0.5), strict=True)
    return horizon, {m: EarlyFusionCEResnet(num_layers=18, modalities=m, compute_dtype="float32").eval()
                     for m in (RGB, LAYOUT)}


def spans_of(rng):
    """One pano's W/D/O spans by type, with a seam-split opening merged last."""
    out = {t: [tuple(sorted(rng.uniform(0.02, 0.95, 2))) for _ in range(rng.integers(0, 3))]
           for t in ("doors", "windows", "openings")}
    out["openings"].append((0.97, 0.03))
    return out


def seeded_floor(seed, n_panos=3):
    rng = np.random.default_rng(seed)
    depths = rng.uniform(1000, 4000, (n_panos, *HW)).astype(np.uint16)
    rgbs = rng.uniform(0, 1, (n_panos, *HW, 3)).astype(np.float32)
    spans = [spans_of(rng) for _ in range(n_panos)]
    hyps = []
    for k in range(BATCH + 2):
        i1, i2 = rng.choice(n_panos, 2, replace=False)
        hyps.append((int(i1), int(i2), AlignmentHypothesis(
            i2Ti1=Sim2.from_theta_deg(rng.uniform(-180, 180), rng.uniform(-1, 1, 2)), wdo_alignment_object="door",
            i1_wdo_idx=k, i2_wdo_idx=0, configuration="identity")))
    return depths, rgbs, spans, hyps


def score(model, modalities, floor, **kw):
    depths, rgbs, _, hyps = floor
    return fused_inference.score_floor_hypotheses(
        model, TrainingConfig(num_layers=18, modalities=modalities, **SIZES), depths, rgbs,
        {i: i for i in range(len(rgbs))}, hyps, batch_size=BATCH, render_cfg=RENDER, use_warp_renders=False,
        device="cpu", **kw)


def recording(monkeypatch, name):
    """Every output of `fused_inference.<name>` in the calls that follow."""
    out = []
    real = getattr(fused_inference, name)

    def record(*a, **k):
        out.append(real(*a, **k))
        return out[-1]

    monkeypatch.setattr(fused_inference, name, record)
    return out


def parser_layouts(boundary: np.ndarray, spans):
    """The layouts MHNet's parser makes of these boundaries and spans."""
    graph = SimpleNamespace(nodes={0: SimpleNamespace(global_Sim2_local=Sim2.identity(), label="room")})
    out = []
    for row, sp in zip(boundary, spans):
        pred = MHNetPanoStructurePrediction(
            corners_in_uv=np.zeros((8, 2)), image_height=HW[0], image_width=HW[1], floor_boundary=row,
            floor_boundary_uncertainty=np.zeros(HW[1]), image_fpath="p.jpg",
            **{t: [MHNetDWO(s, e) for s, e in sp[t]] for t in ("doors", "windows", "openings")})
        pano = pred.convert_to_pano_data(HW[0], HW[1], 0, graph, "p.jpg", 0.0)
        out.append((pano.room_vertices_local_2d, pano.all_wdos))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_the_horizon_path_draws_and_scores_as_the_layouts_path_fed_the_parsers_rooms(nets, monkeypatch, seed):
    horizon, verifiers = nets
    floor = seeded_floor(seed)
    boundaries = recording(monkeypatch, "floor_boundary_bank")
    rasters = recording(monkeypatch, "layout_rasters")
    got = score(verifiers[LAYOUT], LAYOUT, floor, layout_model=horizon, wdo_spans=floor[2])
    (boundary,) = boundaries
    assert boundary.shape == (3, HW[1]) and boundary.dtype == torch.float32
    drawn = [r.clone() for r in rasters]
    rasters.clear()
    layouts = parser_layouts(boundary.numpy(), floor[2])
    assert all(len(room) > 8 for room, _ in layouts) and sum(len(w) for _, w in layouts) >= 3
    want = score(verifiers[LAYOUT], LAYOUT, floor, layouts=layouts)
    assert len(drawn) == len(rasters) == 1 + 2
    for a, b in zip(drawn, rasters):
        assert torch.equal(a, b)
    assert [(g.y_hat, g.prob) for g in got] == [(w.y_hat, w.prob) for w in want]


def test_the_horizon_and_boundary_spans_count_what_they_did(nets):
    horizon, verifiers = nets
    floor = seeded_floor(2)
    profiler.reset_span_record()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        score(verifiers[LAYOUT], LAYOUT, floor, layout_model=horizon, wdo_spans=floor[2])
    spans = profiler.span_record()
    names = [s["name"] for s in spans]
    floor_i, upload, hz, banks, bd, layout = (names.index(f"salve/{n}") for n in (
        "floor", "upload", "horizon", "banks", "boundary", "layout"))
    assert floor_i < upload < hz < banks < bd < layout
    assert all(spans[i]["parent"] == floor_i for i in (upload, hz, banks, bd, layout))
    # On the CPU each forward runs eagerly, a pano a forward.
    chunks = -(-3 // fused_inference.HORIZON_CHUNK)
    assert spans[hz]["counts"] == {"panos": 3, "horizon/panos": 3, "horizon/eager": chunks}
    boundary = fused_inference.floor_boundary_bank(horizon, torch.from_numpy(floor[1]))
    rooms = fused_inference.boundary_layouts(boundary.numpy(), floor[2])
    assert spans[bd]["counts"] == {"d2h_bytes": 3 * HW[1] * 4,
                                   "boundary/vertices": sum(len(room) for room, _ in rooms)}


@pytest.mark.parametrize("path", ["rgb", "layouts"])
def test_the_rgb_and_layouts_paths_take_no_horizon_or_boundary_span(nets, path):
    horizon, verifiers = nets
    floor = seeded_floor(3)
    kw = {}
    if path == "layouts":
        with torch.no_grad():
            boundary = fused_inference.floor_boundary_bank(horizon, torch.from_numpy(floor[1]))
        kw["layouts"] = fused_inference.boundary_layouts(boundary.numpy(), floor[2])
    before = profiler.counter("horizon/panos")
    profiler.reset_span_record()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        score(verifiers[LAYOUT if path == "layouts" else RGB], LAYOUT if path == "layouts" else RGB, floor, **kw)
    names = {s["name"] for s in profiler.span_record()}
    assert "salve/floor" in names and not names & {"salve/horizon", "salve/boundary"}
    assert profiler.counter("horizon/panos") == before


def test_a_layout_model_without_spans_or_beside_layouts_is_refused(nets):
    horizon, verifiers = nets
    floor = seeded_floor(4)
    layouts = fused_inference.boundary_layouts(np.full((3, HW[1]), 40.0, np.float32), floor[2])
    with pytest.raises(ValueError, match="layout_model"):
        score(verifiers[LAYOUT], LAYOUT, floor, layouts=layouts, layout_model=horizon, wdo_spans=floor[2])
    with pytest.raises(ValueError, match="W/D/O spans"):
        score(verifiers[LAYOUT], LAYOUT, floor, layout_model=horizon)
    with pytest.raises(ValueError, match="W/D/O spans"):
        score(verifiers[LAYOUT], LAYOUT, floor, layouts=layouts, wdo_spans=floor[2])
    with pytest.raises(ValueError, match="RGB verifier takes neither"):
        score(verifiers[RGB], RGB, floor, layout_model=horizon, wdo_spans=floor[2])
    with pytest.raises(ValueError, match="2 W/D/O span sets for a bank of 3"):
        score(verifiers[LAYOUT], LAYOUT, floor, layout_model=horizon, wdo_spans=floor[2][:2])


def test_the_cli_scores_a_floor_with_horizonnet_layouts_and_mhnet_wdos(nets, tmp_path, monkeypatch):
    import functools
    import json

    from test_torch_fused_layout import seeded_building

    from salve_tpu_torch.cli import test_fused
    from salve_tpu_torch.dataset.hnet_prediction_loader import load_hnet_predictions
    from salve_tpu_torch.rendering import bev_pair

    horizon, verifiers = nets
    building_id = "0997"
    hyp, raw, depth, mhnet, dropped = seeded_building(tmp_path, building_id)
    ckpt = tmp_path / "six_images.pt"
    torch.save({"model": verifiers[LAYOUT].state_dict(), "opt_state": {}, "step": 0}, ckpt)
    horizon_ckpt = tmp_path / "resnet50_rnn.pth"
    torch.save({"kwargs": {"backbone": "resnet50", "use_rnn": True}, "state_dict": horizon.state_dict()},
               horizon_ckpt)
    argv = ["--hypotheses_save_root", str(hyp), "--raw_dataset_dir", str(raw), "--depth_save_root", str(depth),
            "--ckpt_fpath", str(ckpt), "--serialization_save_dir", str(tmp_path / "preds"), "--num_layers", "18",
            "--resize_px", str(SIZES["resize_h"]), "--crop_px", str(SIZES["train_h"]), "--batch_size", "2",
            "--device", "cpu", "--modalities", *LAYOUT, "--mhnet_predictions_data_root", str(mhnet),
            "--horizonnet_ckpt", str(horizon_ckpt)]
    # The CLI builds the model at the released size; the seeded building's panos are HW.
    monkeypatch.setattr(horizonnet, "load_horizonnet", functools.partial(horizonnet.load_horizonnet, input_hw=HW))
    before = profiler.counter("horizon/panos")
    test_fused.main(argv)
    got = {"y_hat": [], "y_hat_probs": [], "fp0": []}
    for f in sorted((tmp_path / "preds").glob("batch_*.json")):
        data = json.loads(f.read_text())
        for k in got:
            got[k] += data[k]
    # The pano without a prediction has no W/D/Os: its hypothesis is skipped.
    assert len(got["y_hat"]) == 3 and not any(f"_pano_{dropped}." in fp for fp in got["fp0"])

    # The same floor through the scorer: the boundaries computed, the spans MHNet's.
    preds = load_hnet_predictions(building_id, str(raw), str(mhnet))["floor_01"]
    hyps = []
    for label in ("gt_alignment_approx", "incorrect_alignment"):
        for f in sorted((hyp / building_id / "floor_01" / label).glob("*.json")):
            i1, i2 = (int(x) for x in f.stem.split("__")[0].split("_"))
            if dropped not in (i1, i2):
                hyps.append((i1, i2, AlignmentHypothesis(i2Ti1=Sim2.from_json(f), wdo_alignment_object="door",
                                                         i1_wdo_idx=0, i2_wdo_idx=1, configuration="identity")))
    ids = sorted({i for h in hyps for i in h[:2]})
    assert profiler.counter("horizon/panos") - before == len(ids)
    imgs = {int(p.stem.split("_")[-1]): p for p in (raw / building_id / "panos").glob("*.jpg")}
    depths = np.stack([bev_pair.load_depth_mm(str(depth / building_id / f"{imgs[i].stem}.depth.png")) for i in ids])
    rgbs = np.stack([bev_pair.load_pano_rgb(str(imgs[i])) for i in ids]).astype(np.float32)
    cfg = TrainingConfig(num_layers=18, modalities=LAYOUT, resize_h=SIZES["resize_h"], resize_w=SIZES["resize_w"],
                         train_h=SIZES["train_h"], train_w=SIZES["train_w"])
    spans = [{t: [(w.s, w.e) for w in getattr(preds[i], t)] for t in ("doors", "windows", "openings")} for i in ids]
    want = fused_inference.score_floor_hypotheses(
        test_fused.load_verifier(str(ckpt), cfg), cfg, depths, rgbs, {i: k for k, i in enumerate(ids)}, hyps,
        batch_size=2, device="cpu", layout_model=horizon, wdo_spans=spans)
    assert got["y_hat"] == [r.y_hat for r in want]
    assert got["y_hat_probs"] == [r.prob for r in want]
