"""Official ZInD train/val/test building splits (1575 tours).

The split lists are dataset facts published at
https://github.com/zillow/zind/blob/main/zind_partition.json; stored here as
a JSON data file rather than a generated module.

A copy of salve_tpu/dataset/zind_partition.py (no JAX).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

_SPLIT_JSON = Path(__file__).parent / "zind_partition.json"

with open(_SPLIT_JSON, "r") as _f:
    DATASET_SPLITS: Dict[str, List[str]] = json.load(_f)

assert set(DATASET_SPLITS) == {"train", "val", "test"}
