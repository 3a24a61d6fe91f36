"""Port of salve_tpu.hypotheses (see the package docstring)."""
