"""argparse value types that read flags as the JAX package's click CLIs do."""

from __future__ import annotations

import argparse
import os

_TRUE = {"1", "true", "t", "yes", "y", "on"}
_FALSE = {"0", "false", "f", "no", "n", "off"}


class UsageError(Exception):
    """Options that cannot run together; a CLI's `main` exits 2 on it
    through `parser.error`, as click does on click.UsageError."""


def existing_path(value: str) -> str:
    """click.Path(exists=True): the path must exist."""
    if not os.path.exists(value):
        raise argparse.ArgumentTypeError(f"Path '{value}' does not exist.")
    return value


def boolean(value: str) -> bool:
    """click's `type=bool`: true/false, 1/0, yes/no, y/n, t/f, on/off, any case."""
    v = value.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise argparse.ArgumentTypeError(f"'{value}' is not a valid boolean.")
