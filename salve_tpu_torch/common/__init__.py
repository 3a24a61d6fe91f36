"""Port of salve_tpu.common (see the package docstring)."""
