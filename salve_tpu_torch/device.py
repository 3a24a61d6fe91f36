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

Training policy (`deterministic_algorithms`): the verifier's and the depth
net's training and evaluation run with deterministic algorithms, so two runs
from one state, seed and batch give the same bits on the card, as
salve_tpu's seeded step does on XLA:CPU. cuBLAS needs
`CUBLAS_WORKSPACE_CONFIG=:4096:8` in the environment before its first call
for that; the training CLIs (`set_cublas_workspace_config`) and
chip_smoke.py set it. An op with no deterministic CUDA kernel raises under
the policy.

Launch counts: every CUDA kernel wrapper calls `count_launch` each time it
launches its kernel, and nowhere else, so a run can show that the main path
went through the kernels. The counts are the `launches/<kernel>` entries of
the port's counters (utils/profiler.py), so a traced run also finds them on
the span each launch was made in. A launch captured into a CUDA graph counts
once, at its capture; the graph's replays run it again and count
`<graph>/graph_replays` instead (pipeline/fused_inference.py).
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, Optional, Union

import torch

from salve_tpu_torch.utils import profiler

DeviceLike = Union[str, torch.device, None]

KERNELS = ("splat", "fill", "warp", "layout")


def count_launch(kernel: str) -> None:
    profiler.count("launches/" + kernel)


def reset_launch_counts() -> None:
    profiler.reset_counters(*("launches/" + k for k in KERNELS))


def launch_counts() -> Dict[str, int]:
    return {k: profiler.counter("launches/" + k) for k in KERNELS}


def apply_numerics_policy() -> None:
    """Full-float32 matmuls and convolutions on the card (module docstring)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# cuBLAS's fixed workspace, which deterministic matrix products need; it is
# read once, at the process's first cuBLAS call.
CUBLAS_WORKSPACE_CONFIG = ":4096:8"


def set_cublas_workspace_config() -> None:
    """Set `CUBLAS_WORKSPACE_CONFIG` unless the caller's environment does;
    call before the process's first CUDA work."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)


@contextlib.contextmanager
def deterministic_algorithms() -> Iterator[None]:
    """Deterministic algorithms, cuDNN's deterministic convolutions and no
    cuDNN autotuning inside the block; the three flags are restored on exit,
    also when the block raises."""
    saved = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2], saved[3]


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
    """Kernel-wrapper input check: a contiguous CUDA tensor of `dtype` on the
    current device.

    The kernels launch into the current device's context (the C entry points
    ask `cudaGetDevice`, and B2 caches its residency once a process), so a
    tensor on another card raises instead of launching there: a process of
    a mesh calls `torch.cuda.set_device` for its card first
    (parallel/mesh.py).
    """
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    current = torch.cuda.current_device()
    if t.device.index is not None and t.device.index != current:
        raise ValueError(f"{name} lies on {t.device} but the current device is cuda:{current}: "
                         "call torch.cuda.set_device for the tensor's card first")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
