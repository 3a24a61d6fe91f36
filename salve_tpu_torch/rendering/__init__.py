"""Port of salve_tpu.rendering (see the package docstring)."""
