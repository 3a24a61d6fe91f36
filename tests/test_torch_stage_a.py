"""Stage A of the port against salve_tpu on procedural floors (CPU).

Hypothesis lists and exported JSON trees must be equal exactly: which
candidates survive is decided by one float32 division and comparison that
both sides compute under IEEE rounding, and every written transform is the
same float64 host refit. The device product's R and t are float32 sums in
different orders: within atol 1e-5.

Inferred mode reads ModifiedHorizonNet predictions. No such file ships with
the repository, so `_write_predictions` makes seeded ones in the schema the
loader parses (random floor boundaries and W/D/O spans per pano).
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from salve_tpu.common.pano_data import FloorData as JaxFloorData
from salve_tpu.hypotheses import batched as jbatched
from salve_tpu.hypotheses import export as jexport
from salve_tpu_torch.cli.export_alignment_hypotheses import run_export_alignment_hypotheses
from salve_tpu_torch.common.pano_data import FloorData
from salve_tpu_torch.dataset import procedural
from salve_tpu_torch.hypotheses import batched, export, wdo_alignment
from salve_tpu_torch.hypotheses.wdo_alignment import (
    MIN_ALLOWED_GT_WDO_WIDTH_RATIO,
    MIN_ALLOWED_INFERRED_WDO_WIDTH_RATIO,
    AlignTransformType,
)

# (seed, generate_building_json kwargs): a 4x4 grid (10 rooms, the
# generator's cap), two default floors, and a pathological floor.
BUILDINGS = [
    (0, {"n_rows": 4, "n_cols": 4}),
    (2, {}),
    (11, {}),
    (5, {"style": "pathological"}),
]


def _pano_dicts(building):
    """The same floor parsed by the port and by salve_tpu."""
    floor = building["merger"]["floor_01"]
    port = {p.id: p for p in FloorData.from_json(floor, "floor_01").panos}
    ref = {p.id: p for p in JaxFloorData.from_json(floor, "floor_01").panos}
    return port, ref


def _pairs(pano_dict):
    ids = sorted(pano_dict)
    return [(i1, i2) for i1 in ids for i2 in ids if i1 < i2]


def _key(h):
    """Everything a hypothesis carries, the transform as its stored bytes."""
    return (
        h.wdo_alignment_object, h.i1_wdo_idx, h.i2_wdo_idx, h.configuration,
        h.i2Ti1.rotation.tobytes(), h.i2Ti1.translation.tobytes(), h.i2Ti1.scale,
    )


@pytest.mark.parametrize("inferred", [True, False], ids=["inferred_ratio", "gt_ratio"])
@pytest.mark.parametrize("seed,kwargs", BUILDINGS[:3])
def test_batched_lists_equal_salve_tpu_and_the_host_path(seed, kwargs, inferred):
    port_dict, ref_dict = _pano_dicts(procedural.generate_building_json(seed=seed, **kwargs))
    pairs = _pairs(port_dict)
    got = batched.align_floor_pairs_batched(port_dict, pairs, inferred, device="cpu")
    ref = jbatched.align_floor_pairs_batched(ref_dict, pairs, inferred)
    assert sum(len(v) for v in got.values()) > 50
    for pair in pairs:
        assert [_key(h) for h in got[pair]] == [_key(h) for h in ref[pair]], pair
        if inferred:  # the host path applies the freespace check in GT mode
            host, _ = wdo_alignment.align_rooms_by_wd(
                port_dict[pair[0]], port_dict[pair[1]], AlignTransformType.SE2, use_inferred_wdos_layout=True
            )
            assert [_key(h) for h in got[pair]] == [_key(h) for h in host], pair


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("num_configs", [1, 2])
def test_product_fits_match_salve_tpu(num_configs):
    rng = np.random.default_rng(num_configs)
    B, W = 5, 4
    pts1 = rng.uniform(-2, 2, (B, W, 5, 2)).astype(np.float32)
    pts2 = rng.uniform(-2, 2, (B, W, 5, 2)).astype(np.float32)
    w1, w2 = (rng.uniform(0.5, 1.5, (B, W)).astype(np.float32) for _ in range(2))
    v1, v2 = (rng.uniform(size=(B, W)) < 0.8 for _ in range(2))
    args = (pts1, w1, v1, pts2, w2, v2)
    R, t, ok = batched._product_se2_fits(*(_t(a) for a in args), torch.tensor(0.65), num_configs)
    Rj, tj, okj = jbatched._product_se2_fits(*(jnp.asarray(a) for a in args), jnp.float32(0.65), num_configs)
    assert R.shape == Rj.shape == (B, W, W, num_configs, 2, 2)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), rtol=0, atol=1e-5)
    assert np.array_equal(ok.numpy(), np.asarray(okj))


@pytest.mark.parametrize("min_ratio", [MIN_ALLOWED_INFERRED_WDO_WIDTH_RATIO, MIN_ALLOWED_GT_WDO_WIDTH_RATIO])
def test_width_mask_is_bit_exact_one_ulp_around_the_threshold(min_ratio):
    """Widths whose quotient lands on float32(min_ratio) and one ulp to each
    side of it, over several denominators and both orders: the port's mask
    equals salve_tpu's and numpy's IEEE float32 division."""
    thr = np.float32(min_ratio)
    below, above = np.nextafter(thr, np.float32(0)), np.nextafter(thr, np.float32(1))
    wide = np.array([1.0, 1.7, 2.3, 0.9, 3.1], np.float32)
    narrow = []
    for d in wide:
        x = np.float32(thr * d)
        for _ in range(6):
            x = np.nextafter(x, np.float32(0))
        for _ in range(13):
            narrow.append(x)
            x = np.nextafter(x, np.float32(10))
    narrow = np.array(narrow, np.float32)
    widths = np.concatenate([wide, narrow])
    quotients = np.minimum(widths[:, None], widths[None, :]) / np.maximum(widths[:, None], widths[None, :])
    for q in (below, thr, above):
        assert (quotients == q).any(), q
    want = quotients >= thr

    W = len(widths)
    pts = np.zeros((1, W, 5, 2), np.float32)
    valid = np.ones((1, W), bool)
    args = (pts, widths[None], valid, pts, widths[None], valid)
    _, _, ok = batched._product_se2_fits(*(_t(a) for a in args), torch.tensor(thr), 1)
    _, _, okj = jbatched._product_se2_fits(*(jnp.asarray(a) for a in args), jnp.float32(min_ratio), 1)
    assert np.array_equal(ok.numpy()[0, ..., 0], want)
    assert np.array_equal(np.asarray(okj)[0, ..., 0], want)


def _write_building(root: pathlib.Path, bid: str, building) -> str:
    d = root / bid
    d.mkdir(parents=True)
    (d / "zind_data.json").write_text(json.dumps(building))
    return str(d / "zind_data.json")


def _tree(root: pathlib.Path):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def test_exporter_gt_mode_writes_salve_tpu_bytes(tmp_path, capsys):
    raw = tmp_path / "zind"
    flags = {}
    for seed, kwargs in BUILDINGS:
        bid = f"{seed:04d}"
        annot = _write_building(raw, bid, procedural.generate_building_json(seed=seed, **kwargs))
        for side, fn, kw in (("port", export.export_single_building_wdo_alignment_hypotheses, {"device": "cpu"}),
                             ("ref", jexport.export_single_building_wdo_alignment_hypotheses, {})):
            flags[side, bid] = fn(str(tmp_path / side), bid, annot, str(raw), False, **kw)
        assert flags["port", bid] == flags["ref", bid]
    port, ref = _tree(tmp_path / "port"), _tree(tmp_path / "ref")
    assert len(port) > 1000
    assert port.keys() == ref.keys()
    assert all(port[k] == ref[k] for k in port)
    for seed, _ in BUILDINGS:
        labels = {k.split("/")[2] for k in port if k.startswith(f"{seed:04d}/")}
        assert labels == {"gt_alignment_exact", "gt_alignment_approx", "incorrect_alignment"}


def _write_predictions(root: pathlib.Path, bid: str, building, seed: int) -> None:
    """Seeded MHNet prediction JSONs, one per pano of the building: a smooth
    floor boundary below the horizon, and 0-3 spans of each W/D/O type, with
    one opening split by the pano seam now and then."""
    rng = np.random.default_rng(seed)
    out = root / "horizon_net" / bid
    out.mkdir(parents=True)
    for complete in building["merger"]["floor_01"].values():
        for partial_name, partial in complete.items():
            for pano in partial.values():
                stem = pathlib.Path(pano["image_path"]).stem
                u = np.linspace(0, 2 * np.pi, 1024)
                boundary = 330 + 40 * np.sin(u * rng.integers(1, 4) + rng.uniform(0, 6)) + rng.normal(0, 2, 1024)
                feats = {}
                for kind in ("door", "window", "opening"):
                    spans = []
                    for _ in range(rng.integers(0, 4)):
                        s = rng.uniform(0.02, 0.9)
                        spans.append([s, s + rng.uniform(0.02, 0.08)])
                    feats[kind] = spans
                if rng.uniform() < 0.3:
                    feats["opening"] += [[0.001, 0.04], [0.96, 1.0]]
                pred = {
                    "image_height": 512,
                    "image_width": 1024,
                    "room_shape": {
                        "corners_in_uv": rng.uniform(0, 1, (8, 2)).tolist(),
                        "raw_predictions": {
                            "floor_boundary": boundary.tolist(),
                            "floor_boundary_uncertainty": np.zeros(1024).tolist(),
                        },
                    },
                    "wall_features": feats,
                }
                (out / f"{stem}.json").write_text(json.dumps({"predictions": pred}))


def test_exporter_inferred_mode_writes_salve_tpu_bytes(tmp_path, capsys):
    """Inferred mode through the MHNet loader and the batched product."""
    raw, preds = tmp_path / "zind", tmp_path / "preds"
    for seed, kwargs in BUILDINGS[:2]:
        bid = f"{seed:04d}"
        building = procedural.generate_building_json(seed=seed, **kwargs)
        annot = _write_building(raw, bid, building)
        _write_predictions(preds, bid, building, seed)
        got = export.export_single_building_wdo_alignment_hypotheses(
            str(tmp_path / "port"), bid, annot, str(raw), True, str(preds), device="cpu"
        )
        ref = jexport.export_single_building_wdo_alignment_hypotheses(
            str(tmp_path / "ref"), bid, annot, str(raw), True, str(preds)
        )
        assert got == ref
    port, ref = _tree(tmp_path / "port"), _tree(tmp_path / "ref")
    assert sum("incorrect_alignment" in k for k in port) > 100
    assert port.keys() == ref.keys()
    assert all(port[k] == ref[k] for k in port)


def test_cli_gt_mode_on_the_cpu_writes_salve_tpu_bytes(tmp_path):
    raw = tmp_path / "zind"
    seed, kwargs = BUILDINGS[2]
    bid = f"{seed:04d}"
    annot = _write_building(raw, bid, procedural.generate_building_json(seed=seed, **kwargs))
    result = CliRunner().invoke(run_export_alignment_hypotheses, [
        "--raw_dataset_dir", str(raw), "--num_processes", "1", "--hypotheses_save_root", str(tmp_path / "port"),
        "--wdo_source", "ground_truth", "--split", "test", "--building_id", bid, "--device", "cpu",
    ])
    assert result.exit_code == 0, result.output
    jexport.export_single_building_wdo_alignment_hypotheses(str(tmp_path / "ref"), bid, annot, str(raw), False)
    port, ref = _tree(tmp_path / "port"), _tree(tmp_path / "ref")
    assert len(port) > 100 and port == ref
