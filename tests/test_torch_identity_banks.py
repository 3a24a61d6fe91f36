"""The banks of the warp path (rendering/bev_pair.py:render_identity_banks):
one backprojection a surface gives both the identity render and the packed
warp source, bit for bit those of salve_tpu's `render_identity_batched` and
`pack_rgb888(render_identity_bank_extended)`, the config's `is_semantics`
included; the scorer's `build_banks` backprojects each surface once; and no
module of the ops layer reaches up into rendering.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salve_tpu.ops import warp as jwarp
from salve_tpu.rendering import bev_pair as jbev_pair
from salve_tpu_torch.ops import bev as tbev
from salve_tpu_torch.ops.backproject import CEILING_Z_RANGE, FLOOR_Z_RANGE
from salve_tpu_torch.ops.warp import pack_rgb888
from salve_tpu_torch.pipeline import fused_inference
from salve_tpu_torch.rendering import bev_pair
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(img_px=100, meters_per_px=0.1, crop_ratio=0.1)
BANK_PX = 200


def panos(seed=0, b=2, h=64, w=128):
    """u16 depths in mm and RGB quantized to k / 255, as the scorer's banks
    hold them."""
    rng = np.random.default_rng(seed)
    depths = rng.uniform(1000, 4000, (b, h, w)).astype(np.uint16).astype(np.float32)
    rgbs = (rng.integers(0, 256, (b, h, w, 3)) / 255.0).astype(np.float32)
    return depths, rgbs


def counting_clouds(monkeypatch):
    """The calls of `bev_pair.surface_clouds` made from here on."""
    calls = []
    clouds = bev_pair.surface_clouds

    def counting(*args, **kwargs):
        calls.append(args[2])
        return clouds(*args, **kwargs)

    monkeypatch.setattr(bev_pair, "surface_clouds", counting)
    return calls


@pytest.mark.parametrize("is_semantics", [False, True], ids=["texture", "semantics"])
@pytest.mark.parametrize("z_range", [FLOOR_Z_RANGE, CEILING_Z_RANGE], ids=["floor", "ceiling"])
def test_identity_banks_equal_salve_tpus_two_renders(z_range, is_semantics):
    depths, rgbs = panos()
    jcfg = jbev_pair.BEVRenderConfig(**CFG, is_semantics=is_semantics)
    tcfg = bev_pair.BEVRenderConfig(**CFG, is_semantics=is_semantics)
    ref_ident = np.asarray(jbev_pair.render_identity_batched(jnp.asarray(depths), jnp.asarray(rgbs), z_range, jcfg))
    ref_bank = np.asarray(jwarp.pack_rgb888(
        jwarp.render_identity_bank_extended(jnp.asarray(depths), jnp.asarray(rgbs), z_range, jcfg, BANK_PX)))

    ident, bank = bev_pair.render_identity_banks(torch.from_numpy(depths), torch.from_numpy(rgbs), z_range, tcfg,
                                                 BANK_PX)
    assert ident.dtype == torch.uint8 and ident.shape == (2, CFG["img_px"] + 1, CFG["img_px"] + 1, 3)
    assert bank.dtype == torch.int32 and bank.shape == (2, BANK_PX + 1, BANK_PX + 1)
    np.testing.assert_array_equal(ident.numpy(), ref_ident)
    np.testing.assert_array_equal(bank.numpy(), ref_bank)
    assert (ref_ident > 0).mean() > 0.05 and (ref_bank > 0).mean() > 0.01


@pytest.mark.parametrize("use_warp_renders", [True, False], ids=["warp", "direct"])
def test_build_banks_backprojects_each_surface_once(monkeypatch, use_warp_renders):
    depths, rgbs = panos(1)
    cfg = bev_pair.BEVRenderConfig(**CFG)
    d, c = torch.from_numpy(depths), torch.from_numpy(rgbs)
    calls = counting_clouds(monkeypatch)
    got = fused_inference.build_banks(d, c, cfg, use_warp_renders)
    assert sorted(calls) == sorted([CEILING_Z_RANGE, FLOOR_Z_RANGE])
    monkeypatch.undo()

    # Each bank is what its surface's separate renders give.
    want = [bev_pair.render_identity_batched(d, c, zr, cfg) for zr in (CEILING_Z_RANGE, FLOOR_Z_RANGE)]
    if use_warp_renders:
        want = [pack_rgb888(tbev.render_bev_images_batched(*bev_pair.surface_clouds(d, c, zr, cfg), 2 * cfg.img_px,
                                                           cfg.meters_per_px))
                for zr in (CEILING_Z_RANGE, FLOOR_Z_RANGE)] + want
    else:
        want = [d, c] + want
    assert len(got) == 4 and all(torch.equal(g, w) for g, w in zip(got, want))


def test_no_ops_module_imports_rendering():
    for path in sorted((REPO / "salve_tpu_torch" / "ops").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.startswith("salve_tpu_torch.rendering") for n in names), path.name
