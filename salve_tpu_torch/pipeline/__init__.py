"""Port of salve_tpu.pipeline (see the package docstring)."""
