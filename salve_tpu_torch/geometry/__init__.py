"""Port of salve_tpu.geometry (see the package docstring)."""
