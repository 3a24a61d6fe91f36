"""Materialize a ZInD-shaped building directory from GT geometry alone.

Port of salve_tpu/dataset/synthetic_zind.py. Writes the on-disk layout the
pipeline CLIs consume ({building}/zind_data.json,
{building}/panos/floor_XX_..._pano_{i}.jpg and the u16-mm depth cache),
with imagery ray-cast through each floor's multi-room world
(rendering/synthetic.py). Panos go through the port's JPEG encoder (cv2's
bytes), depth maps through `native/png.py` (the decoded u16 arrays equal
imageio's files), and the provider branch reads an existing pano with the
port's JPEG decoder (Pillow's arrays). Host numpy only: a depth provider
runs wherever its model lives.
"""

from __future__ import annotations

import json
import shutil
import zlib
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from salve_tpu_torch.common import posegraph2d


def _ceiling_heights_by_stem(zind_json_fpath: Path) -> Dict[str, float]:
    """Per-pano ego-normalized ceiling_height keyed by image stem.

    ZInD stores ceiling_height relative to the unit camera height; PanoData
    does not parse it, so it is read from the raw JSON here to place the
    rendered world's ceiling plane.
    """
    with open(zind_json_fpath) as f:
        data = json.load(f)
    out: Dict[str, float] = {}
    for floor in data.get("merger", {}).values():
        for complete in floor.values():
            for partial in complete.values():
                for pano in partial.values():
                    if not isinstance(pano, dict) or "image_path" not in pano:
                        continue
                    stem = Path(pano["image_path"]).stem
                    out[stem] = float(pano.get("ceiling_height", 2.0))
    return out


def materialize_synthetic_building(
    src_zind_dir: str,
    building_id: str,
    out_raw_dir: str,
    depth_save_root: Optional[str] = None,
    depth_provider: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    seed: int = 0,
) -> Dict[str, int]:
    """Write panos (and optionally the depth cache) for one building.

    Args:
        src_zind_dir: directory holding {building_id}/zind_data.json (GT).
        out_raw_dir: output raw-dataset root (ZInD shape).
        depth_save_root: if set, also write {root}/{building}/{stem}.depth.png
            u16 millimeter maps (the depth cache's contract).
        depth_provider: optional (H, W, 3) float32 RGB in [0, 1] -> (H, W)
            meters model; by default the exact ray-cast GT depth is written.
        seed: texture seed base.

    Returns:
        {floor_id: n_panos} written.

    Resume contract: each pano and each depth map is its own artifact. An
    existing pano skips the ray cast; an existing depth map is never
    re-derived; a provider fills a missing depth map from an existing pano.
    """
    from salve_tpu_torch.native import jpeg, png
    from salve_tpu_torch.rendering.dataset_renderer import write_jpg
    from salve_tpu_torch.rendering.synthetic import R_FIX, build_floor_world, render_synthetic_pano_world

    bdir = Path(out_raw_dir) / building_id
    (bdir / "panos").mkdir(parents=True, exist_ok=True)
    shutil.copy(Path(src_zind_dir) / building_id / "zind_data.json", bdir / "zind_data.json")

    ceil_by_stem = _ceiling_heights_by_stem(bdir / "zind_data.json")

    written: Dict[str, int] = {}
    for floor_id in posegraph2d.compute_available_floors_for_building(building_id, str(out_raw_dir)):
        pg = posegraph2d.get_gt_pose_graph(building_id, floor_id, str(out_raw_dir))
        # One multi-room world and texture seed per building floor, so panos
        # viewing the same space render agreeing colours.
        world = build_floor_world(pg)
        floor_seed = (seed * 4093 + zlib.crc32(f"{building_id}/{floor_id}".encode())) & 0x7FFFFFFF
        S = float(pg.scale_meters_per_coordinate)
        # One ceiling plane per floor world: the median metric ceiling.
        ceils_m = [ceil_by_stem.get(Path(p.image_path).stem, 2.0) * pg.get_camera_height_m(i)
                   for i, p in pg.nodes.items()]
        floor_ceil_m = float(np.median(ceils_m)) if ceils_m else None
        for i, pano in pg.nodes.items():
            stem = Path(pano.image_path).stem
            pano_fp = bdir / "panos" / f"{stem}.jpg"
            depth_fp = None if depth_save_root is None else Path(depth_save_root) / building_id / f"{stem}.depth.png"
            need_pano = not pano_fp.exists()
            need_depth = depth_fp is not None and not depth_fp.exists()
            if not (need_pano or need_depth):
                continue
            # GT depth comes from the ray cast; a provider needs only the RGB.
            need_raycast = need_pano or (need_depth and depth_provider is None)
            out = None
            if need_raycast:
                cam_xy = pano.global_Sim2_local.transform_from(np.zeros((1, 2)))[0] * S
                out = render_synthetic_pano_world(
                    world,
                    cam_xy=cam_xy,
                    cam_h=pg.get_camera_height_m(i),
                    ceil_h=floor_ceil_m,
                    seed=floor_seed,
                    world_R=np.asarray(pano.global_Sim2_local.rotation, dtype=np.float64) @ R_FIX,
                    door_rects=world.door_rects,
                )
            if need_pano:
                write_jpg(str(pano_fp), out["rgb"])
            if need_depth:
                depth_fp.parent.mkdir(parents=True, exist_ok=True)
                if depth_provider is None:
                    depth_m = out["depth"]
                else:
                    rgb = out["rgb"] if out is not None else jpeg.decode_jpeg(pano_fp)
                    depth_m = np.asarray(depth_provider(rgb.astype(np.float32) / 255.0))
                depth_mm = np.clip(np.round(depth_m * 1000.0), 0, 65535).astype(np.uint16)
                depth_fp.write_bytes(png.encode_png(depth_mm))
        written[floor_id] = len(pg.nodes)
    return written
