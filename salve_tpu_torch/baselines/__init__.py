"""Port of salve_tpu.baselines: so far the ICP registration baseline
(`icp.py`); the OpenSfM / OpenMVG parsers are still to come."""
