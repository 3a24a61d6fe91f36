"""Rules of the PyTorch port: no JAX, the card by default, no hidden fallback.

Every `salve_tpu_torch` module and `chip_smoke.py` import neither jax, flax
nor optax nor any `salve_tpu` module; entry points given no device run on
the CUDA card and raise without one; each CUDA kernel wrapper launches its
kernel or raises, and takes the plain version only for CPU tensors.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from salve_tpu_torch import device as device_mod
from salve_tpu_torch.ops import fill, kernels, splat, warp

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "salve_tpu")


def _port_files():
    files = sorted((REPO / "salve_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 20
    bad = []
    for f in files:
        for name in _imported_roots(f):
            root = name.split(".")[0]
            if root in FORBIDDEN:
                bad.append(f"{f.relative_to(REPO)}: {name}")
    assert not bad, bad


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
    assert device_mod.launch_counts() == {"splat": 0, "fill": 0, "warp": 0}


def test_dispatchers_raise_on_other_devices():
    cell = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        splat.splat_priority_grid(cell, cell, cell.bool(), 2, 2)
    sparse = torch.zeros((1, 4, 4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fill.fill_and_mask(sparse, sparse[..., 0].bool(), sparse[..., 0].bool())


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
    assert {"splat.cu", "fill.cu", "warp.cu"} <= set(names)
    for name in names:
        text = (kernels.CSRC / name).read_text()
        assert "Replaces salve_tpu/ops/pallas_" in text
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
