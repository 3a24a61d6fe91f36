"""Small JSON/file IO helpers (parity: salve/utils/io.py).

A copy of salve_tpu/utils/io.py (no JAX).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Union

_PathLike = Union[str, "os.PathLike[str]"]


def read_json_file(fpath: _PathLike) -> Any:
    """Load JSON from disk."""
    with open(fpath, "r") as f:
        return json.load(f)


def save_json_file(json_fpath: _PathLike, data: Any) -> None:
    """Save data to JSON on disk, creating parent directories as needed."""
    os.makedirs(os.path.dirname(os.path.abspath(str(json_fpath))), exist_ok=True)
    with open(json_fpath, "w") as f:
        json.dump(data, f, indent=4)


def json_files_in_dir(dirpath: _PathLike) -> list:
    """Sorted list of *.json file paths directly under a directory."""
    d = Path(dirpath)
    if not d.exists():
        return []
    return sorted(d.glob("*.json"))
