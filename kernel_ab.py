"""A/B timing of the splat (B1), fill+mask (B2) and shear-warp (B3) CUDA
kernels of two checkouts of this repository, on one card, with one harness.

    python3 kernel_ab.py OTHER_TREE

OTHER_TREE is another checkout (for example the parent commit unpacked with
`git archive` into a directory that .gitignore lists). The script runs itself
four times as a child, in the order other, this, this, other; each child puts
one tree first on sys.path, builds that tree's kernels with its own
`salve_tpu_torch/ops/kernels.py`, makes the same inputs from the same seeds
(4 synthetic 512x1024 panos; 501^2 renders and 1001^2 warp banks, as
chip_smoke.py does) and times, through the tree's public wrappers:

  * B1 at its three main-path shapes: 4x1001^2 (the extended banks),
    4x501^2 (the identity banks) and 32x501^2 (a direct-mode batch), each
    tree's wrapper whole (a separate grid fill included where the tree has
    one), and at cluster sizes 8 and 16 where the tree's wrapper takes a
    `splat_plan`;
  * B2 at 4x1001^2 (the banks) and 32x501^2 (a direct-mode batch);
  * B3 for one batch's ceiling and floor (one pair launch where the tree has
    `warp_banks_auto`, else two single launches, as that tree's score_batch
    makes them), per surface in each rot90 branch, and one bank alone, warm
    and with the L2 flushed before each launch.

The harness (device times behind a sleep kernel, the inputs) is this tree's
chip_smoke.py. Each child prints one JSON line; the parent prints them all
and writes chiprun_out/kernel_ab.json. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def harness():
    """This tree's chip_smoke.py as a module, whichever tree is on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_harness", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    from salve_tpu_torch.dataset.synthetic_bank import make_synthetic_pano_bank
    from salve_tpu_torch.ops import bev, fill, kernels, splat, warp
    from salve_tpu_torch.ops.backproject import CEILING_Z_RANGE, FLOOR_Z_RANGE
    from salve_tpu_torch.rendering import bev_pair
    from salve_tpu_torch.rendering.bev_pair import BEVRenderConfig, surface_clouds

    h = harness()
    dev = torch.device("cuda")
    kernels.load()
    cfg = BEVRenderConfig(img_px=500)
    d_np, r_np = make_synthetic_pano_bank(4, 512, 1024, seed=0)
    depths = torch.as_tensor(d_np.astype(np.float32), device=dev)
    rgbs = torch.as_tensor(r_np, device=dev)
    rng = np.random.default_rng(1)

    res = {"tree": str(tree)}
    xyz, c, v = surface_clouds(depths, rgbs, FLOOR_Z_RANGE, cfg)
    banks_in = h.fill_inputs(bev, splat, xyz, c, v, 1000, cfg.meters_per_px)
    xyz32, c32, v32 = h.direct_batch_clouds(rng, depths, rgbs, 32, cfg)
    direct_in = h.fill_inputs(bev, splat, xyz32, c32, v32, 500, cfg.meters_per_px)
    for name, clouds, px in (("splat_4x1001", (xyz, c, v), 1000), ("splat_4x501", (xyz, c, v), 500),
                             ("splat_32x501", (xyz32, c32, v32), 500)):
        keys = h.splat_keys_at(bev, splat, *clouds, px, cfg.meters_per_px)
        if not torch.equal(splat.splat_priority_grid(*keys, px + 1, px + 1),
                           splat.splat_priority_grid_plain(*keys, px + 1, px + 1)):
            raise AssertionError(f"{tree}: B1 disagrees with its plain version at {name}")
        res[name + "_ms"] = h.time_ms(lambda: splat.splat_priority_grid(*keys, px + 1, px + 1), rounds=7)
        if hasattr(splat, "splat_plan"):  # a tree whose B1 takes a cluster size: time both
            for cl in (8, 16):
                plan = splat.splat_plan((px + 1) ** 2, cl)
                res[f"{name}_cluster{cl}_ms"] = h.time_ms(
                    lambda: splat.splat_priority_grid_cuda(*keys, px + 1, px + 1, plan=plan), rounds=7)
    for name, args in (("fill_4x1001", banks_in), ("fill_32x501", direct_in)):
        if not torch.equal(fill.fill_and_mask(*args), fill.fill_and_mask_plain(*args)):
            raise AssertionError(f"{tree}: B2 disagrees with its plain version at {name}")
        res[name + "_ms"] = h.time_ms(lambda: fill.fill_and_mask(*args), rounds=7)

    if hasattr(bev_pair, "render_identity_banks"):  # a tree that renders both banks of a surface from one cloud
        banks = tuple(bev_pair.render_identity_banks(depths, rgbs, zr, cfg, 1000)[1]
                      for zr in (CEILING_Z_RANGE, FLOOR_Z_RANGE))
    else:
        banks = tuple(warp.pack_rgb888(warp.render_identity_bank_extended(depths, rgbs, zr, cfg, 1000)).contiguous()
                      for zr in (CEILING_Z_RANGE, FLOOR_Z_RANGE))
    pair = hasattr(warp, "warp_banks_auto")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    for n in range(4):
        R, t, idx = h.random_hypotheses(rng, 32, 4, dev, branches=[n] * 32)
        p = warp.shear_warp_params(R, t, 1001, 500, cfg.meters_per_px)
        if pair:
            both = lambda: warp.shear_warp_cuda(banks, idx, p)  # noqa: E731
        else:
            both = lambda: [warp.shear_warp(bk, idx, p) for bk in banks]  # noqa: E731
        for got, bk in zip(both(), banks):
            if not torch.equal(got, warp.shear_warp_plain(bk, idx, p)):
                raise AssertionError(f"{tree}: B3 disagrees with its plain version in rot90^{n}")
        res[f"warp_rot90^{n}_per_surface_ms"] = h.time_ms(both, rounds=7) / 2
        res[f"warp_rot90^{n}_single_ms"] = h.time_ms(lambda: warp.shear_warp(banks[1], idx, p), rounds=7)
        res[f"warp_rot90^{n}_single_cold_l2_ms"] = h.cold_l2_ms(lambda: warp.shear_warp(banks[1], idx, p), flush)
    return res


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        print(json.dumps(child(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    card = harness().card_line()
    runs = []
    for label, tree in (("other", other), ("this", HERE), ("this", HERE), ("other", other)):
        out = subprocess.run([sys.executable, str(HERE / "kernel_ab.py"), "--child", str(tree)],
                             capture_output=True, text=True, cwd=str(tree))
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        row = json.loads(out.stdout.strip().splitlines()[-1])
        row["label"] = label
        runs.append(row)
        print(json.dumps(row), flush=True)
    (HERE / "chiprun_out").mkdir(exist_ok=True)
    (HERE / "chiprun_out" / "kernel_ab.json").write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
