"""Equirectangular projection (port of salve_tpu/geometry/pano_projection.py).

`get_uni_sphere_xyz` is torch, for the backprojection on the card. The
pixel -> world-metric chain below it and its inverse, world-metric -> pixel,
are numpy copies of the reference's host path (the `xp=np` case); the MHNet
prediction loader uses the former.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from salve_tpu_torch.ops import libm
from salve_tpu_torch.ops.numerics import div_const


def get_uni_sphere_xyz(H: int, W: int, device=None) -> torch.Tensor:
    """(H, W, 3) float32 unit-sphere ray grid in the HoHoNet convention.

    Same formula as salve_tpu/geometry/pano_projection.py:157: u spans the
    width with a half-pixel offset, v the height; x right, y down-ish, z up.
    Bit for bit as the JAX package's jitted backprojection computes it:
    the divisions are products with float32 reciprocals (ops/numerics.py),
    and sin and cos are glibc's float32 ones (ops/libm.py), which XLA:CPU
    calls once a row (v) and once a column (u). The grid is a constant of
    (H, W), made once a device: callers must not write into it.
    """
    return _ray_grid(H, W, torch.device("cpu" if device is None else device))


@functools.lru_cache(maxsize=None)
def _ray_grid(H: int, W: int, device: torch.device) -> torch.Tensor:
    jj = torch.arange(H, device=device, dtype=torch.float32)
    ii = torch.arange(W, device=device, dtype=torch.float32)
    u = div_const(-(ii + 0.5), W) * 2 * math.pi
    v = (div_const(jj + 0.5, H) - 0.5) * math.pi
    cv, sv = libm.cosf(v), libm.sinf(v)
    cu, su = libm.cosf(u), libm.sinf(u)
    x = cv[:, None] * cu[None, :]
    y = cv[:, None] * su[None, :]
    z = (-sv)[:, None].expand(H, W)
    return torch.stack([x, y, z], dim=-1)


def pixel_to_sphere(points_pix: np.ndarray, width: int) -> np.ndarray:
    """(N,2) pano pixel coords [x,y] -> spherical [theta, phi] on the unit sphere.

    theta in [-pi, pi] (left edge -> right edge), phi in [-pi/2, pi/2]
    (bottom -> top); [0, 0] is the image center. Height is width/2.
    """
    height = width / 2
    x_arr = points_pix[..., 0]
    y_arr = np.clip(points_pix[..., 1], 0, height - 1)

    theta = x_arr / (width - 1) * (2.0 * math.pi) - math.pi
    phi = (1.0 - y_arr / (height - 1)) * math.pi - math.pi / 2.0
    return np.stack([theta, phi], axis=-1)


def sphere_to_cartesian(points_sph: np.ndarray) -> np.ndarray:
    """Spherical [theta, phi(, rho)] -> room-Cartesian [x, y, z] (left-handed).

    The image center (theta=0, phi=0) maps to the +z axis direction.
    """
    theta = points_sph[..., 0]
    phi = np.clip(points_sph[..., 1], -math.pi / 2, math.pi / 2)
    rho = points_sph[..., 2] if points_sph.shape[-1] == 3 else np.ones_like(theta)

    rho_cos_phi = rho * np.cos(phi)
    x = rho_cos_phi * np.sin(theta)
    y = rho * np.sin(phi)
    z = rho_cos_phi * np.cos(theta)
    return np.stack([x, y, z], axis=-1)


def room_cartesian_to_worldmetric(cartesian_coordinates: np.ndarray, camera_height: float) -> np.ndarray:
    """Intersect unit-sphere rays with the floor plane; output right-handed metric coords.

    Rays scaled so the (downward) vertical component equals camera height;
    axes permuted so z becomes vertical; x negated for handedness.
    """
    flipped = cartesian_coordinates * np.asarray([1.0, 1.0, -1.0])
    y = flipped[..., 1:2]
    world = flipped / y * camera_height
    return np.stack([-world[..., 0], world[..., 2], world[..., 1]], axis=-1)


def pixel_to_worldmetric(points_px: np.ndarray, image_width: int, camera_height_m: float) -> np.ndarray:
    """Full chain pixel -> world-metric, valid for points on the floor."""
    points_sph = pixel_to_sphere(points_px, width=image_width)
    points_cartesian = sphere_to_cartesian(points_sph)
    return room_cartesian_to_worldmetric(points_cartesian, camera_height_m)


def cartesian_to_sphere(points_cart: np.ndarray) -> np.ndarray:
    """Room-Cartesian [x,y,z] -> spherical [theta, phi, rho]."""
    x, y, z = points_cart[..., 0], points_cart[..., 1], points_cart[..., 2]
    theta = np.arctan2(x, z)
    rho = np.sqrt(x * x + y * y + z * z)
    phi = np.arcsin(y / rho)
    return np.stack([theta, phi, rho], axis=-1)


def sphere_to_pixel(points_sph: np.ndarray, width: int) -> np.ndarray:
    """Spherical [theta, phi] -> pano pixel coords [x, y]."""
    height = width / 2
    theta = points_sph[..., 0]
    phi = points_sph[..., 1]
    x_arr = (theta + math.pi) / (2.0 * math.pi) * (width - 1)
    y_arr = (1.0 - (phi + math.pi / 2.0) / math.pi) * (height - 1)
    return np.stack([x_arr, y_arr], axis=-1)


def worldmetric_to_room_cartesian(points_worldmetric: np.ndarray, camera_height_m: float) -> np.ndarray:
    """Inverse of :func:`room_cartesian_to_worldmetric` for floor points.

    Of the two antipodal unit-sphere rays that reach a floor location, the
    downward-looking one (negative sphere-frame y) is the physical one
    (salve_tpu/geometry/pano_projection.py:105).
    """
    x = points_worldmetric[..., 0]
    y = points_worldmetric[..., 1]
    # Un-permute: world = [-f.x, f.z, f.y] * (h / f.y) for f = cart * [1,1,-1].
    w = np.stack([-x, np.full_like(x, camera_height_m), y], axis=-1)
    norm = np.sqrt(np.sum(w * w, axis=-1, keepdims=True))
    flipped = -w / norm  # the downward-looking (f.y < 0) solution
    return flipped * np.asarray([1.0, 1.0, -1.0])


def worldmetric_to_pixel(points_worldmetric: np.ndarray, image_width: int, camera_height_m: float) -> np.ndarray:
    """Full chain world-metric -> pano pixel, valid for points on the floor:
    the round-trip inverse of :func:`pixel_to_worldmetric`."""
    cart = worldmetric_to_room_cartesian(points_worldmetric, camera_height_m)
    sph = cartesian_to_sphere(cart)
    return sphere_to_pixel(sph, width=image_width)


def xy_to_u(xy: np.ndarray) -> np.ndarray:
    """World-metric (N,2) -> horizontal texture coordinate u in [0,1]."""
    return (np.arctan2(xy[..., 0], xy[..., 1]) / math.pi + 1.0) / 2.0


def xy_to_uv(xy: np.ndarray, camera_height_m: float, img_w: int, img_h: int) -> np.ndarray:
    """World-metric floor points -> pano texture coordinates in [0,W]x[0,H]."""
    u = xy_to_u(xy)
    depths = np.sqrt(xy[..., 0] ** 2 + xy[..., 1] ** 2)
    v = 1.0 - np.arctan(depths / camera_height_m) / math.pi
    return np.stack([u * img_w, v * img_h], axis=-1)
