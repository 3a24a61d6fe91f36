"""Port of salve_tpu.utils (see the package docstring)."""
