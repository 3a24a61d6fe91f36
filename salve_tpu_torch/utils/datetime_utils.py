"""Datetime utilities (port of salve_tpu/utils/datetime_utils.py)."""

import datetime


def generate_datetime_string() -> str:
    """YYYY_MM_DD_HH_MM_SS (24-hour)."""
    return f"{datetime.datetime.now():%Y_%m_%d_%H_%M_%S}"
