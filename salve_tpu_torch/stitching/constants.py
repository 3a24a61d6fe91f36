"""Prediction-file naming + camera constants (parity: salve/stitching/constants.py).

A copy of salve_tpu/stitching/constants.py (no JAX).
"""

ROOM_SHAPE_PARTIAL_V1_FILENAME = "rmx-rse-v1_predictions.json"
JOINT_V1_FILENAME = "rmx-joint-v1_predictions.json"
JOINT_MANH_V2_FILENAME = "rmx-manh-joint-v2_predictions.json"
JOINT_MADORI_V1_FILENAME = "rmx-madori-v1_predictions.json"

ROOM_SHAPE_TOTAL_FILENAME = "rmx-rse-total.json"
WDO_FILENAME1 = "rmx-dwo-ssd_predictions.json"
WDO_FILENAME2 = "rmx-dwo-rcnn_predictions.json"
JOINT_FILENAME = "rmx-joint-v1_predictions.json"

WDO_CODE = ["window", "door", "opening"]

# Default camera height in the floor_map.json room-shape data.
DEFAULT_CAMERA_HEIGHT = 0.4042260417272217

IMAGE_WIDTH_PX = 1024
IMAGE_HEIGHT_PX = 512
