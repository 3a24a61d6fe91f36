"""Port of salve_tpu.algorithms (see the package docstring)."""
