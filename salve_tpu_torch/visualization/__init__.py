"""Port of salve_tpu.visualization: so far the 3D pose-graph plot (`pose_viz.py`)."""
