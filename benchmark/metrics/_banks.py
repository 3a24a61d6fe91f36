"""What the readers of B1 and B2 inside the banks share: a kernel's share
of its roofline over the kernels of its name launched inside the traced
floors' `bench/build_banks` ranges (the scorer's `build_banks`, which the
scoring drivers wrap), whether the banks ran eagerly or as a replayed CUDA
graph, which calls no Python launcher for a driver to wrap.

A floor's launches follow from its pano count (the range's record) and
the cell's own files: the pano size of its mix, the render size and the
mode of its configuration. A surface's banks are one cloud of the
surface's pano rows (ops/backproject.py:`surface_row_window`) a pano,
splatted (B1) and filled (B2) at (img_px + 1)^2 and, in warp mode, again
at (2 img_px + 1)^2; each launch's bytes and operations are those that
`rooflines.py` counts for the drivers' wrapped launchers. None where the
ranges hold another number of the kernel than the floors launch (the CPU,
or a floor that captured its graph there), or where the cells of the
run's driver differ in those sizes."""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from benchmark import harness
from benchmark.rooflines import fill_bytes, fill_ops, least_seconds, splat_bytes

KERNEL_NAMES = {"b1": "splat_max_kernel", "b2": "fill_mask_kernel"}


def floor_launches(panos: int, h: int, w: int, img_px: int, warp: bool) -> Dict[str, List[Tuple[int, int]]]:
    """(bytes, float ops) of each B1 and each B2 launch of a floor's banks."""
    from salve_tpu_torch.ops.backproject import CEILING_Z_RANGE, DEFAULT_CROP_RATIO, FLOOR_Z_RANGE, surface_row_window

    sides = (img_px + 1, 2 * img_px + 1) if warp else (img_px + 1,)
    out: Dict[str, List[Tuple[int, int]]] = {"b1": [], "b2": []}
    for z_range in (CEILING_Z_RANGE, FLOOR_Z_RANGE):
        r0, r1 = surface_row_window(h, z_range, DEFAULT_CROP_RATIO)
        for s in sides:
            out["b1"].append((splat_bytes(panos, (r1 - r0) * w, s * s), 0))
            out["b2"].append((fill_bytes(panos, s, s), fill_ops(panos, s, s)))
    return out


def cell_sizes(driver: Optional[str]) -> Optional[Tuple[int, int, int, bool]]:
    """(pano height, pano width, img_px, warp mode) of the cells whose mix
    runs `driver`, where there are some and they agree."""
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    found = set()
    for cell in manifest["workloads"]:
        spec = harness.load_cell(cell["name"])
        mix, config = spec["mix"], spec["config"]
        if mix.get("driver") == driver:
            found.add((*mix["pano_hw"], config["img_px"], config["use_warp_renders"]) if "pano_hw" in mix else None)
    return found.pop() if len(found) == 1 and None not in found else None


def banks_roofline_pct(ctx, layer: str) -> Optional[float]:
    t = ctx.get("trace")
    floors = ctx.get("launches", {}).get("build_banks", [])
    sizes = cell_sizes(ctx.get("driver")) if t is not None and floors else None
    if sizes is None:
        return None
    launches = [x for f in floors for x in floor_launches(f["panos"], *sizes)[layer]]
    kernels = [k for k in t.kernels_in("build_banks") if KERNEL_NAMES[layer] in k.name]
    if len(kernels) != len(launches):
        return None
    least = [least_seconds(b, ops, ctx.get("kind", "")) for b, ops in launches]
    spent = sum(k.dur for k in kernels)
    if None in least or spent <= 0:
        return None
    return 100.0 * sum(least) / spent
