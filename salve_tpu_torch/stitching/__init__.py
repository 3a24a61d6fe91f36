"""Floorplan stitching: fuse per-pano layouts into final room shapes.

Parity: salve/stitching/ — dense 1024-point boundaries from MHNet
floor_boundary + uncertainty, room grouping by layout overlap,
confidence-weighted multi-pano shape fusion (reproject every pano's
boundary into a reference pano, keep the lowest-uncertainty wall per
texture column), and final refinement/union.

The reference leaned on Shapely/GEOS for polygons and scipy interpolate;
here polygons are plain (N,2) arrays with numpy predicates (ray casting,
segment intersection) — vectorized over all 1024 boundary columns at once.

A copy of salve_tpu/stitching/ (no JAX, no networkx; matplotlib through
`utils/plotting.py`, inside the figures). The raster containment behind
room grouping and the stitch IoU runs in torch (float64) on a `device`,
None being the CUDA card; the rest is host code.
"""
