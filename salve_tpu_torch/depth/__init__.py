"""Port of salve_tpu.depth: the u16 mm depth-map cache and its pluggable
producer (see depth/cache.py)."""

from salve_tpu_torch.depth.cache import (  # noqa: F401
    depth_fpath_for_pano,
    infer_depth_if_nonexistent,
    register_depth_model,
)
