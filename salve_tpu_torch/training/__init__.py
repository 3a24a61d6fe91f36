"""Port of salve_tpu.training (see the package docstring)."""
