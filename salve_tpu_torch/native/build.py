"""Build a C file of this directory into a shared library of its own, at first use.

Each shim (`jpeg_codec.c`, `png_unfilter.c`) becomes its own `.so`, never
part of the CUDA kernels' `libsalve_kernels.so` (ops/kernels.py), and links
no library beyond the C library: the image IO builds on any machine with a C
compiler, card or not. The host's C
compiler (`cc`, or `$CC`; nvcc needs one anyway) builds it into
`build/salve_tpu_torch/native/<name>-<hash>/` beside the package, a
directory `.gitignore` lists. The hash covers the source and the flags, so
an edit rebuilds and an unchanged tree reuses its build. The library is
written under a temporary name and renamed into place, so concurrent test
workers see all of it or nothing. `function` hands out each C function with
its argument types set once, under a lock, so threads that decode and encode
in parallel never call one whose types another thread is still setting.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

HERE = Path(__file__).resolve().parent
BUILD_ROOT = HERE.parents[1] / "build" / "salve_tpu_torch" / "native"
# -ffp-contract=off: no compiler fuses a product into an add (the batch
# loader's resize in jpeg_codec.c rounds as the x86-64 reference does).
CFLAGS = ("-O2", "-ffp-contract=off", "-pthread", "-shared", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}
_FUNCTIONS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
_LOCK = threading.RLock()


def compiler() -> str:
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if not cc:
        raise RuntimeError("no C compiler (cc) found: the native image IO builds at first use")
    return cc


def library_path(source: str) -> Path:
    h = hashlib.sha256((HERE / source).read_bytes())
    h.update(" ".join(CFLAGS).encode())
    return BUILD_ROOT / f"{Path(source).stem}-{h.hexdigest()[:16]}" / f"lib{Path(source).stem}.so"


def load(source: str) -> ctypes.CDLL:
    """Build `source` (once per hash) and load it; raise with the compiler's
    output where it does not build."""
    with _LOCK:
        if source in _LOADED:
            return _LOADED[source]
        path = library_path(source)
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
            os.close(fd)
            out = subprocess.run([compiler(), *CFLAGS, str(HERE / source), "-o", tmp],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if out.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"cc failed on {source}:\n{out.stdout}")
            os.replace(tmp, path)
        try:
            _LOADED[source] = ctypes.CDLL(str(path))
        except OSError as err:
            raise RuntimeError(f"{path} does not load: {err}") from err
        return _LOADED[source]


def function(source: str, name: str, argtypes: Sequence, restype) -> ctypes._CFuncPtr:
    """C function `name` of `source`'s library, its types set once."""
    key = (source, name)
    with _LOCK:
        if key not in _FUNCTIONS:
            fn = load(source)[name]  # a fresh function object, private to this table
            fn.argtypes = list(argtypes)
            fn.restype = restype
            _FUNCTIONS[key] = fn
        return _FUNCTIONS[key]
