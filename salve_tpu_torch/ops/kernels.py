"""Build and load the hand-written Hopper kernels (`salve_tpu_torch/csrc`).

Route: every `.cu` file under `csrc/` is compiled by `nvcc` for `sm_90a`
into an object, all at once in parallel, and the objects are linked into one
shared library with a plain C interface, loaded with `ctypes`. Nothing
includes PyTorch's headers, so a build takes seconds. The library lands in
`build/salve_tpu_torch/<hash>/` beside the package (a directory `.gitignore`
lists). The hash covers every file under `csrc/` (headers included) and the
flags, so editing any of them rebuilds on first use and an unchanged tree
reuses its build.

No `--use_fast_math`: the fill kernel's bit-exactness rests on IEEE-rounded
adds, products and quotients.

Nothing here runs at import: the CPU tests import every module, and a
build needs `nvcc` and a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "salve_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "salve_splat_max": [_P, _P, _P, _P, _I, _I, _I, _P],
    "salve_splat_max_blocks": [_P],
    "salve_l2_atomic_probe": [_P, _L, _L, _L, _P],
    "salve_dsmem_atomic_probe": [_I, _I, _I, _P, _P],
    "salve_fill_mask": [_P, _P, _P, _P, _I, _I, _I, _P],
    "salve_fill_div_check": [_P, _P],
    "salve_shear_warp": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an earlier build was reused
    ptxas_log: str


_LOADED: Optional[KernelLibrary] = None


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def sources() -> list:
    """The translation units: every `.cu` file under `csrc/`, by name."""
    return sorted(p.name for p in CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(str(path.relative_to(CSRC)).encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> tuple:
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    t0 = time.perf_counter()
    procs = []
    for name in sources():
        obj = tmp / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs, objs = [], []
    for name, obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {name}\n{out}")
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        objs.append(str(obj))
    lib_tmp = tmp / "libsalve_kernels.so"
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         *objs, "-o", str(lib_tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    final = out_dir / "libsalve_kernels.so"
    os.replace(lib_tmp, final)  # atomic: a concurrent loader sees all or nothing
    log = "\n".join(logs)
    (out_dir / "ptxas.log").write_text(log)
    shutil.rmtree(tmp, ignore_errors=True)
    return final, time.perf_counter() - t0, log


def load() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA card")
    out_dir = BUILD_ROOT / _source_hash()
    path = out_dir / "libsalve_kernels.so"
    if path.exists():
        seconds = 0.0
        log_path = out_dir / "ptxas.log"
        log = log_path.read_text() if log_path.exists() else ""
    else:
        path, seconds, log = _build(out_dir)
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _LOADED = KernelLibrary(lib=lib, path=path, build_seconds=seconds, ptxas_log=log)
    return _LOADED


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream
