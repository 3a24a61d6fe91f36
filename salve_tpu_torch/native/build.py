"""Build a C file of this directory into a shared library of its own, at first use.

Each shim (`jpeg_decode.c`, `png_unfilter.c`) becomes its own `.so`, never
part of the CUDA kernels' `libsalve_kernels.so` (ops/kernels.py): a machine
without libjpeg then loses the JPEG decode and nothing else. The host's C
compiler (`cc`, or `$CC`; nvcc needs one anyway) builds it into
`build/salve_tpu_torch/native/<name>-<hash>/` beside the package, a
directory `.gitignore` lists. The hash covers the source and the flags, so
an edit rebuilds and an unchanged tree reuses its build. The library is
written under a temporary name and renamed into place, so concurrent test
workers see all of it or nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

HERE = Path(__file__).resolve().parent
BUILD_ROOT = HERE.parents[1] / "build" / "salve_tpu_torch" / "native"
CFLAGS = ("-O2", "-shared", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


def compiler() -> str:
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if not cc:
        raise RuntimeError("no C compiler (cc) found: the native readers build at first use")
    return cc


def library_path(source: str, libs: Sequence[str]) -> Path:
    h = hashlib.sha256((HERE / source).read_bytes())
    h.update(" ".join((*CFLAGS, *libs)).encode())
    return BUILD_ROOT / f"{Path(source).stem}-{h.hexdigest()[:16]}" / f"lib{Path(source).stem}.so"


def load(source: str, libs: Sequence[str] = ()) -> ctypes.CDLL:
    """Build `source` (once per hash) and load it; raise with the compiler's
    output where it does not build."""
    key = f"{source}:{' '.join(libs)}"
    if key in _LOADED:
        return _LOADED[key]
    path = library_path(source, libs)
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
        os.close(fd)
        out = subprocess.run([compiler(), *CFLAGS, str(HERE / source), *libs, "-o", tmp],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if out.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"cc failed on {source}:\n{out.stdout}")
        os.replace(tmp, path)
    try:
        _LOADED[key] = ctypes.CDLL(str(path))
    except OSError as err:  # e.g. a library it links against is missing here
        raise RuntimeError(f"{path} does not load: {err}") from err
    return _LOADED[key]
