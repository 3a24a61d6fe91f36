"""Port of salve_tpu.depth (see the package docstring)."""
