"""Blocking shell execution (parity: salve/utils/subprocess_utils.py).

A copy of salve_tpu/utils/subprocess_utils.py (no JAX).
"""

import subprocess
from typing import Optional, Tuple


def run_command(
    cmd: str, return_output: bool = False
) -> Tuple[Optional[bytes], Optional[bytes]]:
    """Execute a shell command, blocking until completion."""
    (stdout_data, stderr_data) = subprocess.Popen(
        cmd, shell=True, stdout=subprocess.PIPE
    ).communicate()
    if return_output:
        return stdout_data, stderr_data
    return None, None
