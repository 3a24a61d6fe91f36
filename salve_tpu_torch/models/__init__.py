"""Port of salve_tpu.models (see the package docstring)."""
