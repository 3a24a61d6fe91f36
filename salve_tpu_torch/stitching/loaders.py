"""Per-pano prediction-file loaders (parity: salve/stitching/loaders.py).

A copy of salve_tpu/stitching/loaders.py (no JAX).
"""

from __future__ import annotations

import abc
import json
import logging
import os
from typing import Any, Dict, List

from salve_tpu_torch.stitching.constants import (
    JOINT_MADORI_V1_FILENAME,
    ROOM_SHAPE_PARTIAL_V1_FILENAME,
    ROOM_SHAPE_TOTAL_FILENAME,
    WDO_FILENAME1,
    WDO_FILENAME2,
)

DEFAULT_DATA_TYPE = {"rse": ["partial_v1"], "dwo": ["rcnn"]}

logger = logging.getLogger(__name__)


class AbstractLoader(abc.ABC):
    @abc.abstractmethod
    def get_room_shape_predictions(self, pano_id: str, type: str = "partial") -> dict:
        ...

    @abc.abstractmethod
    def get_dwo_predictions(self, pano_id: str) -> dict:
        ...


class MemoryLoader(AbstractLoader):
    """Loads rmx-* prediction JSONs for every pano under a directory tree.

    Layout: {data_root}/{panoid}/{rmx-..._predictions.json}, pano IDs being
    length-10 hex strings.
    """

    def __init__(
        self, data_root: str, data_type: Dict[str, List[str]] = DEFAULT_DATA_TYPE
    ) -> None:
        self.data_root = data_root
        self.data_type = data_type
        self._data: Dict[str, Dict[str, Any]] = {"per_pano_predictions": {}}
        self._check_data_type()
        self._load_predictions()

    def _check_data_type(self) -> None:
        for key in ("rse", "dwo"):
            if key not in self.data_type or not self.data_type[key]:
                raise Exception("InternalImplementationError")

    def _load_predictions(self) -> None:
        folders = os.listdir(self.data_root)
        panoids = [d for d in folders if len(d) == 10 and not d.startswith(".")]
        for panoid in panoids:
            self._data["per_pano_predictions"][panoid] = {"rse": {}, "dwo": {}}
            for rse_type in self.data_type["rse"]:
                self._data["per_pano_predictions"][panoid]["rse"][rse_type] = None
                self._load_room_shape_predictions(panoid, rse_type)
            for dwo_type in self.data_type["dwo"]:
                self._data["per_pano_predictions"][panoid]["dwo"][dwo_type] = None
                self._load_dwo_predictions(panoid, dwo_type)

    def _get_prediction_file_path(self, panoid: str, file_name: str) -> str:
        return os.path.join(self.data_root, panoid, file_name)

    def _load_room_shape_predictions(self, panoid: str, type: str = "partial_v1") -> None:
        if type == "total":
            file_name = ROOM_SHAPE_TOTAL_FILENAME
        elif type == "partial_v1":
            file_name = ROOM_SHAPE_PARTIAL_V1_FILENAME
        elif type == "joint_madori_v1":
            file_name = JOINT_MADORI_V1_FILENAME
        else:
            raise Exception(f"InternalImplementationError: Unrecognized type {type}")

        path = self._get_prediction_file_path(panoid, file_name)
        if not os.path.isfile(os.path.abspath(path)):
            logger.warning("memory_loader: prediction_path %s doesn't exist.", path)
            return
        with open(path) as f:
            if type in ("partial_v1", "joint_madori_v1"):
                content = json.load(f)[0]
            else:
                content = json.load(f)
            if "predictions" in content:
                content = content["predictions"]
        self._data["per_pano_predictions"][panoid]["rse"][type] = content

    def _load_dwo_predictions(self, panoid: str, type: str = "rcnn") -> None:
        if type != "rcnn":
            raise Exception(f"InternalImplementationError: Unrecognized type {type}")
        # Prefer the SSD file when present, falling back to RCNN (parity :126-129).
        path = self._get_prediction_file_path(panoid, WDO_FILENAME1)
        if not os.path.isfile(path):
            path = self._get_prediction_file_path(panoid, WDO_FILENAME2)
        if not os.path.isfile(os.path.abspath(path)):
            logger.warning("memory_loader: prediction_path %s doesn't exist.", path)
            return
        with open(path) as f:
            self._data["per_pano_predictions"][panoid]["dwo"][type] = json.load(f)[
                "predictions"
            ]

    def get_room_shape_predictions(self, pano_id: str, type: str = "partial_v1") -> dict:
        # A panoid with no prediction directory at all (partial prediction
        # runs) behaves like a missing file: None, so callers skip the pano
        # instead of dying on KeyError.
        rec = self._data["per_pano_predictions"].get(pano_id)
        return rec["rse"].get(type) if rec is not None else None

    def get_dwo_predictions(self, pano_id: str, type: str = "rcnn") -> dict:
        rec = self._data["per_pano_predictions"].get(pano_id)
        return rec["dwo"].get(type) if rec is not None else None

    def pano_ids(self) -> List[str]:
        return list(self._data["per_pano_predictions"].keys())
