"""The port's file-contract Stage B renderer against salve_tpu's, on the CPU.

A procedural building is materialized by salve_tpu (JPEG panos through cv2,
u16 depth PNGs), its GT-mode hypotheses exported, and seeded MHNet files
written for the layout modality. Both packages render it; tolerance: none,
the file trees (names and bytes) are equal, through the library and through
the CLI, for
  * the warp arm (identity and extended banks, host NN warp, the identity
    encode cache),
  * the direct arm (both panos of a pair in one render batch),
  * the layout modality.
Also: the resume contract, a failed write raising, the host warp bit-equal
to salve_tpu's and to the port's torch gather, and
`cli/render_dataset_bev.py` end to end with jax, imageio, PIL, cv2 and click
absent.
"""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from salve_tpu_torch.rendering import dataset_renderer as port
from torch_threads import child_env, one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
BID = "9990"
HIDDEN = ("jax", "jaxlib", "flax", "optax", "salve_tpu", "imageio", "PIL", "cv2", "click")
# Hypotheses kept per label type: enough for two direct batches of 8 pairs
# a surface, few enough for the reference's CPU renders.
KEEP = {"gt_alignment_approx": 2, "incorrect_alignment": 5}


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def building(tmp_path_factory):
    from salve_tpu.dataset import procedural
    from salve_tpu.dataset.synthetic_zind import materialize_synthetic_building
    from salve_tpu_torch.dataset.seeded_predictions import write_seeded_mhnet_predictions
    from salve_tpu_torch.hypotheses.export import export_single_building_wdo_alignment_hypotheses

    root = tmp_path_factory.mktemp("corpus")
    b = procedural.generate_building_json(5, n_rows=1, n_cols=3)
    (root / "zind" / BID).mkdir(parents=True)
    (root / "zind" / BID / "zind_data.json").write_text(json.dumps(b))
    materialize_synthetic_building(str(root / "zind"), BID, str(root / "raw"), depth_save_root=str(root / "depth"))
    export_single_building_wdo_alignment_hypotheses(str(root / "hyp"), BID, str(root / "raw" / BID / "zind_data.json"),
                                                    str(root / "raw"), False, device="cpu")
    for label, keep in KEEP.items():
        files = sorted((root / "hyp" / BID / "floor_01" / label).glob("*.json"))
        assert len(files) >= keep
        for f in files[keep:]:
            f.unlink()
    write_seeded_mhnet_predictions(root / "mhnet", BID, b, 0)
    # Level floor boundaries (a round room of about 33 vertices after the
    # loader's RDP) in place of the seeded noisy ones (about 600): the
    # reference's XLA layout raster holds (64, 501, 501, vertices) arrays,
    # about 39 GB at 600 vertices and 4.5 GB at 33 on this CPU.
    for k, f in enumerate(sorted((root / "mhnet" / "horizon_net" / BID).glob("*.json"))):
        pred = json.loads(f.read_text())
        pred["predictions"]["room_shape"]["raw_predictions"]["floor_boundary"] = [300.0 + 20.0 * k] * 1024
        f.write_text(json.dumps(pred))
    return root


def _kwargs(root: Path) -> dict:
    return dict(depth_save_root=str(root / "depth"), raw_dataset_dir=str(root / "raw"),
                hypotheses_save_root=str(root / "hyp"), split=None, building_id=BID)


def _render(pkg: str, root: Path, out: Path, modality: str, use_warp=None) -> int:
    if pkg == "ref":
        from salve_tpu.rendering import dataset_renderer as mod

        extra = {}
    else:
        mod, extra = port, {"device": "cpu"}
    if modality == "layout":
        return mod.render_pairs(bev_save_root=str(out / "unused"), layout_save_root=str(out), render_modalities=["layout"],
                                mhnet_predictions_data_root=str(root / "mhnet"), **_kwargs(root), **extra)
    return mod.render_pairs(bev_save_root=str(out), layout_save_root=None, render_modalities=["rgb_texture"],
                            use_warp=use_warp, **_kwargs(root), **extra)


N_PAIRS = 2 * sum(KEEP.values())  # pairs x surfaces
ARMS = {"warp": ("rgb_texture", True), "direct": ("rgb_texture", False), "layout": ("layout", None)}


@pytest.fixture(scope="module")
def reference_trees(building, tmp_path_factory):
    """salve_tpu's trees of the three arms, rendered once."""
    out = tmp_path_factory.mktemp("reference")
    trees = {}
    for arm, (modality, use_warp) in ARMS.items():
        n = _render("ref", building, out / arm, modality, use_warp)
        assert n == (N_PAIRS if modality == "rgb_texture" else sum(KEEP.values()))
        trees[arm] = _tree(out / arm)
        assert len(trees[arm]) == 2 * n
    return trees


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_tree_equals_reference(building, reference_trees, tmp_path, arm):
    modality, use_warp = ARMS[arm]
    _render("port", building, tmp_path / arm, modality, use_warp)
    assert _tree(tmp_path / arm) == reference_trees[arm]


def test_resume_renders_only_missing_pairs(building, tmp_path):
    out = tmp_path / "bev"
    assert _render("port", building, out, "rgb_texture", use_warp=True) == N_PAIRS
    first = _tree(out)
    assert _render("port", building, out, "rgb_texture", use_warp=True) == 0
    victim = sorted(out.rglob("*.jpg"))[3]
    victim.unlink()
    assert _render("port", building, out, "rgb_texture", use_warp=True) == 1
    assert _tree(out) == first


def test_a_failed_write_raises(building, tmp_path, monkeypatch):
    def refuse(path, img, quality=95):
        raise OSError(f"disk full: {path}")

    monkeypatch.setattr(port.jpeg, "write_jpeg", refuse)
    for use_warp in (True, False):
        with pytest.raises(OSError, match="disk full"):
            _render("port", building, tmp_path / f"bev_{use_warp}", "rgb_texture", use_warp)


def test_warp_default_follows_the_device():
    assert port.resolve_corpus_warp_default(torch.device("cuda")) is True
    assert port.resolve_corpus_warp_default(torch.device("cpu")) is False


def test_host_warp_equals_reference_and_torch_gather():
    """The host warp is salve_tpu's, bit for bit, in both its forms. Against
    the gather warp (`warp_bank_sim2_nn`, bit-exact to the jitted reference)
    it differs where the reference's own two warps differ: XLA fuses the
    rotate-translate into FMAs and numpy does not, which flips a nearest
    neighbour at an exact rounding boundary (salve_tpu's bound, 5e-5 of the
    pixels, tests/parity/test_warp_drift.py)."""
    from salve_tpu.ops import warp as jwarp
    from salve_tpu_torch.ops import warp

    rng = np.random.default_rng(7)
    p, b, side = 3, 6, 201
    bank = rng.integers(0, 1 << 24, (p, side, side), dtype=np.int64).astype(np.int32)
    theta = rng.uniform(-np.pi, np.pi, b)
    c, s = np.cos(theta), np.sin(theta)
    R = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2).astype(np.float32)  # (b, 2, 2)
    t = rng.uniform(-1.5, 1.5, (b, 2)).astype(np.float32)
    idx = rng.integers(0, p, b)
    got = warp.warp_bank_sim2_nn_host(bank, R, t, 100, 0.02, bank_idx=idx)
    np.testing.assert_array_equal(got, jwarp.warp_bank_sim2_nn_host(bank, R, t, 100, 0.02, bank_idx=idx))
    np.testing.assert_array_equal(warp.warp_bank_sim2_nn_host(bank[idx], R, t, 100, 0.02), got)
    gather = warp.warp_bank_sim2_nn(torch.from_numpy(bank), torch.from_numpy(R), torch.from_numpy(t), 100, 0.02,
                                    bank_idx=torch.from_numpy(idx)).numpy()
    assert np.mean(gather != got) < 5e-5
    assert (got > 0).any() and (got == 0).any()


RUN = """
import importlib, json, sys
hidden, argv = json.loads(sys.argv[1]), json.loads(sys.argv[2])
sys.modules.update(dict.fromkeys(hidden))
importlib.import_module("salve_tpu_torch.cli.render_dataset_bev").main(argv)
for name in hidden:
    assert sys.modules[name] is None, name
"""


def test_cli_runs_without_jax_imageio_pil_cv2_and_click(building, reference_trees, tmp_path):
    """Both arms and the layout modality through the CLI, in a process where
    the packages the card's machine lacks are absent: the reference's trees."""
    base = ["--raw_dataset_dir", str(building / "raw"), "--depth_save_root", str(building / "depth"),
            "--hypotheses_save_root", str(building / "hyp"), "--building_id", BID, "--device", "cpu",
            "--num_processes", "2"]
    runs = {
        "warp": ["--bev_save_root", str(tmp_path / "warp"), "--use_warp_renders"],
        "direct": ["--bev_save_root", str(tmp_path / "direct"), "--no_use_warp_renders"],
        "layout": ["--bev_save_root", str(tmp_path / "unused"), "--layout_save_root", str(tmp_path / "layout"),
                   "--mhnet_predictions_data_root", str(building / "mhnet")],
    }
    for arm, extra in runs.items():
        proc = subprocess.run([sys.executable, "-c", RUN, json.dumps(HIDDEN), json.dumps(base + extra)], cwd=REPO,
                              capture_output=True, text=True, timeout=600, env=child_env())
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "Rendered" in proc.stdout
        assert _tree(tmp_path / arm) == reference_trees[arm], arm
