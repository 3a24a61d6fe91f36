"""CSV/TSV reading (port of salve_tpu/utils/csv_utils.py)."""

import csv
from typing import Any, Dict, List


def read_csv(fpath: str, delimiter: str = ",") -> List[Dict[str, Any]]:
    """Read a .csv/.tsv file as a list of row dictionaries."""
    with open(fpath) as csvfile:
        return list(csv.DictReader(csvfile, delimiter=delimiter))
