"""Port of salve_tpu.ops (see the package docstring)."""
