"""Device resolution, the float32 numerics policy, and kernel launch counts.

Device rule: an entry point given `device=None` runs on the CUDA card. With
no card it raises; it never carries on on the CPU unless the caller names
`device="cpu"` (as the CPU tests do).

Numerics policy on the card (applied by `resolve_device`):
  * `torch.backends.cuda.matmul.allow_tf32 = False` — float32 matrix
    products in full float32 (PyTorch's default, stated here explicitly);
  * `torch.backends.cudnn.allow_tf32 = False` — float32 cuDNN convolutions
    in full float32 instead of PyTorch's TF32 default. TF32 keeps ~3
    decimal digits, the same trap as the TPU's default bf16 conv passes
    (salve_tpu/ops/bev.py:_box_counts). The verifier's production dtype is
    bf16 (TrainingConfig.compute_dtype), which this policy does not touch.

Launch counts: every CUDA kernel wrapper adds one to its entry in
`LAUNCHES` each time it launches its kernel, and nowhere else, so a run can
show that the main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

LAUNCHES: Dict[str, int] = {"splat": 0, "fill": 0, "warp": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def apply_numerics_policy() -> None:
    """Full-float32 matmuls and convolutions on the card (module docstring)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> the CUDA card; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "salve_tpu_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run the plain versions."
            )
        apply_numerics_policy()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def require_cuda_tensor(name: str, t: torch.Tensor, dtype: Optional[torch.dtype] = None) -> None:
    """Kernel-wrapper input check: a contiguous CUDA tensor of `dtype`."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
