"""Port of salve_tpu.dataset (see the package docstring)."""
