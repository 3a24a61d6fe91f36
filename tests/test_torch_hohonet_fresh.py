"""HoHoNet depth computed inside the fused scorer, on the CPU.

Weights are seeded (`models/hohonet.py:seeded_hohonet`, HoHoNet's `.pth`
key layout) at input_hw 128x256; the verifier is a seeded float32
ResNet-18. Tolerances:
  * the port's HoHoNetDepth against the benchmark's plain reference
    (benchmark/reference/hohonet.py): within 2e-5 m on depths near 2.5 m.
    The two compute the same layers in other orders (a 1x1 projection as a
    matrix product or a 1x1 convolution, the query or the scores scaled,
    Flax's or torch's layer-norm variance, the width resampling's blend);
    float32's rounding over the trunk's 90 layers reads 2-4e-6 m.
  * the depth the scorer computes (`fused_inference.depth_mm_bank`, one pano a forward)
    is, bit for bit, the cache provider's, and so are the verdicts and
    probabilities scored from either.
"""

import json

import numpy as np
import pytest
import torch

from benchmark.reference import hohonet as ref_hohonet
from salve_tpu_torch.common.alignment_hypothesis import AlignmentHypothesis
from salve_tpu_torch.depth import cache
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.models import hohonet as th
from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet
from salve_tpu_torch.native import jpeg, png
from salve_tpu_torch.pipeline.fused_inference import depth_mm_bank, score_floor_hypotheses
from salve_tpu_torch.rendering.bev_pair import BEVRenderConfig, load_depth_mm, load_pano_rgb
from salve_tpu_torch.training.config import TrainingConfig
from salve_tpu_torch.utils import profiler
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HW = (128, 256)
TINY = dict(num_layers=18, resize_h=64, resize_w=64, train_h=56, train_w=56,
            modalities=("ceiling_rgb_texture", "floor_rgb_texture"), compute_dtype="float32")
RENDER = BEVRenderConfig(img_px=100, meters_per_px=0.1, crop_ratio=0.1)
POSES = [(0.0, 0.0, 0.0), (45.0, 1.0, -0.5), (90.0, -1.0, 0.5), (-150.0, 0.4, 0.9)]
PANO_IDS = (0, 2, 7)


@pytest.fixture(scope="module")
def nets():
    torch.manual_seed(0)
    return th.seeded_hohonet(HW, seed=3), EarlyFusionCEResnet(num_layers=18, compute_dtype="float32").eval()


@pytest.fixture(scope="module")
def building(tmp_path_factory, nets):
    """A floor of three JPEG panos with hypotheses and no depth cache, and
    the depth model as a `.pth`."""
    root = tmp_path_factory.mktemp("fresh")
    rng = np.random.default_rng(0)
    pano_dir = root / "zind" / "0999" / "panos"
    pano_dir.mkdir(parents=True)
    for pid in PANO_IDS:
        jpeg.write_jpeg(pano_dir / f"floor_01_partial_room_{pid:02d}_pano_{pid}.jpg",
                        rng.integers(0, 255, (64, 128, 3)).astype(np.uint8))
    for label, (i1, i2), th_deg, t in (("gt_alignment_approx", (0, 2), 30.0, [1.0, 0.5]),
                                       ("incorrect_alignment", (0, 2), 120.0, [-2.0, 0.0]),
                                       ("incorrect_alignment", (2, 7), -45.0, [0.0, 3.0])):
        d = root / "hyp" / "0999" / "floor_01" / label
        d.mkdir(parents=True, exist_ok=True)
        name = f"{i1}_{i2}__door_0_{int(th_deg) % 7}_identity.json"
        Sim2.from_theta_deg(th_deg, np.array(t)).save_as_json(str(d / name))
    ckpt = root / "hoho.pth"
    torch.save(nets[0].state_dict(), ckpt)
    return root, str(ckpt)


def _rgbs(root):
    return np.stack([load_pano_rgb(str(p)) for p in sorted((root / "zind" / "0999" / "panos").glob("*.jpg"))])


def _hyps():
    return [(0, 1, AlignmentHypothesis(i2Ti1=Sim2.from_theta_deg(th_deg, np.array([tx, ty])),
                                       wdo_alignment_object="door", i1_wdo_idx=k, i2_wdo_idx=0,
                                       configuration="identity"))
            for k, (th_deg, tx, ty) in enumerate(POSES)]


@pytest.mark.parametrize("weights", ["seeded_hohonet", "benchmark"])
def test_the_port_agrees_with_the_plain_reference(nets, weights):
    from benchmark.hohonet_weights import make_state_dict

    model = nets[0]
    if weights == "benchmark":
        model = th.HoHoNetDepth(HW).eval()
        model.load_state_dict(make_state_dict(11, "cpu", HW), strict=True)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == ref_hohonet.state_shapes(HW)
    rgb = torch.rand(2, *HW, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model(rgb)
    ref = ref_hohonet.ReferenceHoHoNet(model.state_dict(), HW)(rgb)
    assert 0.5 < float(ref.min()) and float(ref.max()) < 5.0
    assert float((got - ref).abs().max()) <= 2e-5


@pytest.mark.parametrize("pano_hw", [HW, (256, 512)], ids=["at_input_hw", "resized"])
def test_a_floors_bank_equals_its_panos_one_by_one(nets, pano_hw):
    hoho = nets[0]
    rgbs = torch.rand(3, *pano_hw, 3, generator=torch.Generator().manual_seed(2))
    bank = depth_mm_bank(hoho, rgbs)
    assert bank.shape == (3, *pano_hw) and bank.dtype == torch.float32 and bank.is_contiguous()
    assert torch.equal(bank, torch.round(bank)) and 500 < float(bank.min()) and float(bank.max()) < 5000
    assert torch.equal(bank, torch.cat([depth_mm_bank(hoho, rgbs[i:i + 1]) for i in range(3)]))
    provider_hw = [th.resize_linear(hoho(th.resize_linear(rgbs[i], HW)[None])[0], pano_hw) for i in range(3)]
    assert torch.equal(bank, cache.meters_to_mm(torch.stack(provider_hw)))


def test_scoring_from_rgb_equals_scoring_from_the_filled_cache(nets, building, tmp_path):
    """The depth computed in the scorer is the cache's: the same mm, hence
    the same verdicts, as the provider's PNGs read back."""
    hoho, verifier = nets
    root, ckpt = building
    rgbs = _rgbs(root)
    kw = dict(batch_size=3, render_cfg=RENDER, use_warp_renders=False, device="cpu")
    got = score_floor_hypotheses(verifier, TrainingConfig(**TINY), None, rgbs[:2], {0: 0, 1: 1}, _hyps(),
                                 depth_model=hoho, **kw)
    cache.register_depth_model(th.load_hohonet_depth_provider(ckpt, HW, device="cpu"))
    try:
        fpaths = sorted((root / "zind" / "0999" / "panos").glob("*.jpg"))[:2]
        depths = np.stack([load_depth_mm(cache.infer_depth_if_nonexistent(str(tmp_path), "0999", str(f)))
                           for f in fpaths])
    finally:
        cache.register_depth_model(None)
    want = score_floor_hypotheses(verifier, TrainingConfig(**TINY), depths, rgbs[:2], {0: 0, 1: 1}, _hyps(), **kw)
    np.testing.assert_array_equal(depth_mm_bank(hoho, torch.from_numpy(rgbs[:2].astype(np.float32))).numpy(),
                                  depths)
    assert [g.y_hat for g in got] == [w.y_hat for w in want]
    assert [g.prob for g in got] == [w.prob for w in want]
    with pytest.raises(ValueError, match="depth_model"):
        score_floor_hypotheses(verifier, TrainingConfig(**TINY), depths, rgbs[:2], {0: 0, 1: 1}, _hyps(),
                               depth_model=hoho, **kw)
    with pytest.raises(ValueError, match="depth_model"):
        score_floor_hypotheses(verifier, TrainingConfig(**TINY), None, rgbs[:2], {0: 0, 1: 1}, _hyps(), **kw)


def test_the_depth_span_counts_its_panos_and_the_upload_only_rgb(nets):
    hoho, verifier = nets
    rgbs = np.random.default_rng(3).uniform(0, 1, (3, *HW, 3)).astype(np.float32)
    before = profiler.counter("depth/panos")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        score_floor_hypotheses(verifier, TrainingConfig(**TINY), None, rgbs, {0: 0, 1: 1, 2: 2}, _hyps(),
                               batch_size=4, render_cfg=RENDER, use_warp_renders=False, device="cpu",
                               depth_model=hoho)
    spans = profiler.span_record()
    names = [s["name"] for s in spans]
    floor = names.index("salve/floor")
    upload, depth, banks = (names.index(f"salve/{n}") for n in ("upload", "depth", "banks"))
    assert floor < upload < depth < banks
    assert spans[depth]["parent"] == floor and spans[upload]["parent"] == floor
    # On the CPU each forward runs eagerly.
    assert spans[depth]["counts"] == {"panos": 3, "depth/panos": 3, "depth/eager": 3}
    assert spans[upload]["counts"]["h2d_bytes"] == rgbs.nbytes
    assert profiler.counter("depth/panos") == before + 3


def _old_mm(depth_m):
    """The cache's conversion as it was written before `meters_to_mm`."""
    return np.clip(np.round(depth_m * 1000.0), 0, 65535).astype(np.uint16)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_the_cache_writes_the_bytes_it_wrote_before(tmp_path, dtype):
    rng = np.random.default_rng(4)
    depth_m = rng.uniform(-1.0, 70.0, (512, 1024)).astype(dtype)
    depth_m[0, :8] = np.array([0.0005, 0.0015, 0.0025, 1.2345, 1.2355, -0.0004, 65.5354, 65.5356], dtype=dtype)
    img = tmp_path / "b" / "p.jpg"
    img.parent.mkdir()
    jpeg.write_jpeg(img, np.zeros((8, 16, 3), np.uint8))
    cache.register_depth_model(lambda rgb: depth_m)
    try:
        written = cache.infer_depth_if_nonexistent(str(tmp_path / "depth"), "b", str(img))
    finally:
        cache.register_depth_model(None)
    assert open(written, "rb").read() == png.encode_png(_old_mm(depth_m))
    np.testing.assert_array_equal(cache.meters_to_mm(torch.from_numpy(depth_m)).numpy().astype(np.uint16),
                                  _old_mm(depth_m))


def test_the_cli_computes_a_floors_missing_depth_in_the_scorer(nets, building, tmp_path):
    """`--hohonet_ckpt`: a floor with no cached depth is scored with its depth
    computed in the scorer, no PNG is written, and the batches are those the
    cache path writes."""
    from salve_tpu_torch.cli import test_fused

    hoho, verifier = nets
    root, ckpt = building
    vckpt = tmp_path / "verifier.pt"
    torch.save(verifier.state_dict(), vckpt)
    common = ["--hypotheses_save_root", str(root / "hyp"), "--raw_dataset_dir", str(root / "zind"),
              "--ckpt_fpath", str(vckpt), "--num_layers", "18", "--resize_px", "64", "--crop_px", "56",
              "--batch_size", "2", "--no_warp_renders", "--device", "cpu"]
    test_fused.main(common + ["--depth_save_root", str(tmp_path / "none"), "--serialization_save_dir",
                              str(tmp_path / "fresh"), "--hohonet_ckpt", ckpt, "--hohonet_input_hw", "128,256"])
    assert not (tmp_path / "none").exists()
    cache.register_depth_model(th.load_hohonet_depth_provider(ckpt, HW, device="cpu"))
    try:
        test_fused.main(common + ["--depth_save_root", str(tmp_path / "cached"), "--serialization_save_dir",
                                  str(tmp_path / "from_cache")])
    finally:
        cache.register_depth_model(None)
    assert len(list((tmp_path / "cached" / "0999").glob("*.depth.png"))) == len(PANO_IDS)
    fresh = sorted((tmp_path / "fresh").glob("batch_*.json"))
    assert len(fresh) == 2
    for f in fresh:
        assert json.loads(f.read_text()) == json.loads((tmp_path / "from_cache" / f.name).read_text())
