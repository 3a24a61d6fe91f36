"""Port of salve_tpu.cli (see the package docstring)."""
