"""Port of salve_tpu.baselines: the ICP registration baseline (`icp.py`), the
OpenSfM / OpenMVG reconstruction parsers (`opensfm.py`, `openmvg.py`) and
their evaluation against ZInD GT poses (`sfm_eval.py`)."""
