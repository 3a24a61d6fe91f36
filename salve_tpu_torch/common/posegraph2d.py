"""2D pose graphs: GT loading, Sim(3) eval alignment, pose-error metrics.

Parity: salve/common/posegraph2d.py, with GTSAM/GTSFM replaced by the
NumPy Pose3/Sim3 types and the batched RANSAC alignment in
salve_tpu_torch.algorithms.pose_alignment.

A copy of salve_tpu/common/posegraph2d.py (no JAX); `draw_edge` takes
matplotlib through `utils/plotting.py`. The Sim(3) alignment takes a
`device` (None: the CUDA card), passed on to the batched RANSAC.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

import salve_tpu_torch.algorithms.pose_alignment as pose_alignment
import salve_tpu_torch.utils.io as io_utils
from salve_tpu_torch.common.pano_data import FloorData, PanoData
from salve_tpu_torch.device import DeviceLike
from salve_tpu_torch.geometry.poses import Pose3, Sim3
from salve_tpu_torch.geometry.rotations import rotmat2theta_deg, wrap_angle_deg
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.utils import plotting

# Average over 1575 ZInD buildings / 2453 valid scales; used when a floor's
# scale annotation is missing.
ZIND_AVERAGE_SCALE_METERS_PER_COORDINATE = 3.5083


class PoseGraph2d(NamedTuple):
    """Pose graph for a single floor.

    Notation: wSi = (wRi, wti, s) such that p_w = wSi * p_i.

    Attributes:
        building_id: ZInD building ID.
        floor_id: floor ID within the building.
        nodes: pano ID -> PanoData (pose + optional layout/W/D/Os).
        scale_meters_per_coordinate: world-normalized -> world-metric scale.
    """

    building_id: str
    floor_id: str
    nodes: Dict[int, PanoData]
    scale_meters_per_coordinate: float

    def pano_ids(self) -> List[int]:
        return list(self.nodes.keys())

    def __repr__(self) -> str:
        return (
            f"Graph has {len(self.nodes)} nodes in Building {self.building_id}, "
            f"{self.floor_id}: {self.nodes.keys()}"
        )

    def get_camera_height_m(self, pano_id: int) -> float:
        """Metric camera height: floor scale x pano scale x 1.0 (ego-normalized height)."""
        worldmetric_s_worldnormalized = self.scale_meters_per_coordinate
        worldnormalized_s_egonormalized = self.nodes[pano_id].global_Sim2_local.scale
        return worldmetric_s_worldnormalized * worldnormalized_s_egonormalized

    def as_json(self, json_fpath: str) -> None:
        """Serialize the pose graph (poses + layouts) to JSON.

        Parity: salve/common/posegraph2d.py:277 declares this API but raises
        NotImplementedError; here it round-trips through from_json.
        """
        from salve_tpu_torch.utils.io import save_json_file

        data = {
            "building_id": self.building_id,
            "floor_id": self.floor_id,
            "scale_meters_per_coordinate": float(self.scale_meters_per_coordinate),
            "nodes": {
                str(i): {
                    "global_Sim2_local": {
                        "R": pano.global_Sim2_local.rotation.flatten().tolist(),
                        "t": pano.global_Sim2_local.translation.flatten().tolist(),
                        "s": float(pano.global_Sim2_local.scale),
                    },
                    "room_vertices_local_2d": np.asarray(
                        pano.room_vertices_local_2d, dtype=float
                    ).tolist(),
                    "image_path": pano.image_path,
                    "label": pano.label,
                }
                for i, pano in self.nodes.items()
            },
        }
        save_json_file(json_fpath, data)

    @classmethod
    def from_json(cls, json_fpath: str) -> "PoseGraph2d":
        """Inverse of as_json."""
        from salve_tpu_torch.utils.io import read_json_file

        data = read_json_file(json_fpath)
        nodes = {}
        for key, nd in data["nodes"].items():
            s2 = nd["global_Sim2_local"]
            nodes[int(key)] = PanoData(
                id=int(key),
                global_Sim2_local=Sim2(
                    R=np.asarray(s2["R"], dtype=np.float64).reshape(2, 2),
                    t=np.asarray(s2["t"], dtype=np.float64),
                    s=float(s2["s"]),
                ),
                room_vertices_local_2d=np.asarray(nd["room_vertices_local_2d"]),
                image_path=nd["image_path"],
                label=nd["label"],
            )
        return cls(
            building_id=data["building_id"],
            floor_id=data["floor_id"],
            nodes=nodes,
            scale_meters_per_coordinate=data["scale_meters_per_coordinate"],
        )

    def draw_edge(self, i1: int, i2: int, color: str) -> None:
        """Plot a dotted line between two pano centers (parity: :491)."""
        plt = plotting.pyplot("PoseGraph2d.draw_edge", agg=False)

        t1 = self.nodes[i1].global_Sim2_local.transform_from(np.zeros((1, 2))).squeeze()
        t2 = self.nodes[i2].global_Sim2_local.transform_from(np.zeros((1, 2))).squeeze()
        plt.plot([t1[0], t2[0]], [t1[1], t2[1]], c=color, linestyle="dotted", alpha=0.6)

    # -- constructors ----------------------------------------------------------
    @classmethod
    def from_floor_data(
        cls, building_id: str, fd: FloorData, scale_meters_per_coordinate: float
    ) -> "PoseGraph2d":
        return cls(
            building_id=building_id,
            floor_id=fd.floor_id,
            nodes={p.id: p for p in fd.panos},
            scale_meters_per_coordinate=scale_meters_per_coordinate,
        )

    @classmethod
    def from_wRi_list(
        cls, wRi_list: List[Optional[np.ndarray]], building_id: str, floor_id: str
    ) -> "PoseGraph2d":
        """Rotation-only graph with dummy metadata (used by rotation averaging)."""
        nodes = {
            i: PanoData(
                id=i,
                global_Sim2_local=Sim2(R=wRi, t=np.zeros(2), s=1.0),
                room_vertices_local_2d=np.zeros((0, 2)),
                image_path="",
                label="",
            )
            for i, wRi in enumerate(wRi_list)
            if wRi is not None
        }
        return cls(building_id, floor_id, nodes, ZIND_AVERAGE_SCALE_METERS_PER_COORDINATE)

    @classmethod
    def from_wSi_list(
        cls, wSi_list: List[Optional[Sim2]], gt_floor_pose_graph: "PoseGraph2d"
    ) -> "PoseGraph2d":
        """Global-pose list -> graph, scraping layouts/W/D/Os from the GT graph."""
        wRi_list = [wSi.rotation if wSi else None for wSi in wSi_list]
        wti_list = [wSi.translation if wSi else None for wSi in wSi_list]
        return cls.from_wRi_wti_lists(wRi_list, wti_list, gt_floor_pose_graph)

    @classmethod
    def from_wRi_wti_lists(
        cls,
        wRi_list: List[Optional[np.ndarray]],
        wti_list: List[Optional[np.ndarray]],
        gt_floor_pg: "PoseGraph2d",
    ) -> "PoseGraph2d":
        nodes = {}
        for i, (wRi, wti) in enumerate(zip(wRi_list, wti_list)):
            if wRi is None or wti is None:
                continue
            global_Sim2_local = Sim2(R=wRi, t=wti, s=1.0)
            gt_node = gt_floor_pg.nodes[i]
            doors = copy.deepcopy(gt_node.doors)
            windows = copy.deepcopy(gt_node.windows)
            openings = copy.deepcopy(gt_node.openings)
            for wdo in (doors or []) + (windows or []) + (openings or []):
                wdo.global_Sim2_local = copy.deepcopy(global_Sim2_local)
            nodes[i] = PanoData(
                id=i,
                global_Sim2_local=global_Sim2_local,
                room_vertices_local_2d=gt_node.room_vertices_local_2d,
                image_path=gt_node.image_path,
                label=gt_node.label,
                doors=doors,
                windows=windows,
                openings=openings,
            )
        return cls(
            gt_floor_pg.building_id,
            gt_floor_pg.floor_id,
            nodes,
            ZIND_AVERAGE_SCALE_METERS_PER_COORDINATE,
        )

    @classmethod
    def from_aligned_est_poses_and_inferred_layouts(
        cls, aligned_est_floor_pose_graph: "PoseGraph2d", inferred_floor_pose_graph: "PoseGraph2d"
    ) -> "PoseGraph2d":
        """Combine estimated global poses with inferred room layouts."""
        nodes = {}
        for i, epd in aligned_est_floor_pose_graph.nodes.items():
            ipd = inferred_floor_pose_graph.nodes[i]
            nodes[i] = PanoData(
                id=i,
                global_Sim2_local=epd.global_Sim2_local,
                room_vertices_local_2d=ipd.room_vertices_local_2d,
                image_path=ipd.image_path,
                label=ipd.label,
                doors=ipd.doors,
                windows=ipd.windows,
                openings=ipd.openings,
            )
        return cls(
            aligned_est_floor_pose_graph.building_id,
            aligned_est_floor_pose_graph.floor_id,
            nodes,
            aligned_est_floor_pose_graph.scale_meters_per_coordinate,
        )

    # -- eval ------------------------------------------------------------------
    def as_3d_pose_graph(self) -> List[Optional[Pose3]]:
        """Trivial 2D -> 3D lift, indexed 0..max_id."""
        num_images = max(self.nodes.keys()) + 1
        wTi_list: List[Optional[Pose3]] = [None] * num_images
        for i, pano_obj in self.nodes.items():
            wTi_list[i] = Pose3.from_rot2_trans2(
                pano_obj.global_Sim2_local.rotation, pano_obj.global_Sim2_local.translation
            )
        return wTi_list

    def measure_aligned_abs_pose_error(
        self, gt_floor_pg: "PoseGraph2d"
    ) -> Tuple[float, float, np.ndarray, np.ndarray]:
        """Pose errors between already-aligned pose graphs (deg, units, arrays)."""
        return pose_alignment.compute_pose_errors_3d(
            gt_floor_pg.as_3d_pose_graph(), self.as_3d_pose_graph()
        )

    def measure_unaligned_abs_pose_error(
        self, gt_floor_pg: "PoseGraph2d", device: DeviceLike = None
    ) -> Tuple[float, float, np.ndarray, np.ndarray]:
        """Align to GT first (robust Sim(3)), then measure pose errors."""
        _, aligned_bTi_list_est = self.align_by_Sim3_to_ref_pose_graph(
            ref_pose_graph=gt_floor_pg, device=device
        )
        return pose_alignment.compute_pose_errors_3d(
            gt_floor_pg.as_3d_pose_graph(), aligned_bTi_list_est
        )

    def align_by_Sim3_to_ref_pose_graph(
        self, ref_pose_graph: "PoseGraph2d", device: DeviceLike = None
    ) -> Tuple["PoseGraph2d", List[Optional[Pose3]]]:
        aTi_list_ref = ref_pose_graph.as_3d_pose_graph()
        bTi_list_est = self.as_3d_pose_graph()
        bTi_list_est.extend([None] * (len(aTi_list_ref) - len(bTi_list_est)))
        aligned_bTi_list_est, aSb = pose_alignment.ransac_align_poses_sim3_ignore_missing(
            aTi_list_ref, bTi_list_est, device=device
        )
        ref_pano_id = list(ref_pose_graph.nodes.keys())[0]
        gt_scale = ref_pose_graph.nodes[ref_pano_id].global_Sim2_local.scale
        aligned_est_pose_graph = self.apply_Sim3(a_Sim3_b=aSb, gt_scale=gt_scale)
        return aligned_est_pose_graph, aligned_bTi_list_est

    def apply_Sim3(self, a_Sim3_b: Sim3, gt_scale: float) -> "PoseGraph2d":
        """Apply a (projected) Sim(3) to every pose + W/D/O in the graph."""
        aligned = copy.deepcopy(self)
        a_Sim2_b = convert_Sim3_to_Sim2(a_Sim3_b)
        for i in self.nodes.keys():
            pd = aligned.nodes[i]
            a_Sim2_i = a_Sim2_b.compose(pd.global_Sim2_local)
            pd.global_Sim2_local = Sim2(
                R=a_Sim2_i.rotation, t=a_Sim2_i.translation * a_Sim2_i.scale, s=gt_scale
            )
            for wdos in (pd.windows, pd.openings, pd.doors):
                for j in range(len(wdos or [])):
                    wdos[j] = wdos[j].apply_Sim2(a_Sim2_b, gt_scale=gt_scale)
        return aligned

    def measure_avg_abs_rotation_err(self, gt_floor_pg: "PoseGraph2d") -> float:
        """Mean absolute rotation error after global angular (Karcher-style) alignment."""
        common = [i for i in self.nodes if i in gt_floor_pg.nodes]
        gt_thetas = np.array([gt_floor_pg.nodes[i].global_Sim2_local.theta_deg for i in common])
        est_thetas = np.array([self.nodes[i].global_Sim2_local.theta_deg for i in common])
        # Circular mean of per-node angle difference aligns the two rotation sets.
        diffs = np.deg2rad(gt_thetas - est_thetas)
        offset = math.degrees(math.atan2(np.mean(np.sin(diffs)), np.mean(np.cos(diffs))))
        errs = [wrap_angle_deg(gt, est + offset) for gt, est in zip(gt_thetas, est_thetas)]
        return float(np.mean(errs))

    def measure_avg_rel_rotation_err(
        self, gt_floor_pg: "PoseGraph2d", gt_edges: List[Tuple[int, int]], verbose: bool = False
    ) -> float:
        """Mean relative-rotation error over specified edges (alignment-free)."""
        errs = []
        for i1, i2 in gt_edges:
            if not (i1 in self.nodes and i2 in self.nodes):
                continue
            i2Ti1_gt = (
                gt_floor_pg.nodes[i2].global_Sim2_local.inverse().compose(
                    gt_floor_pg.nodes[i1].global_Sim2_local
                )
            )
            i2Ti1 = self.nodes[i2].global_Sim2_local.inverse().compose(
                self.nodes[i1].global_Sim2_local
            )
            err = wrap_angle_deg(i2Ti1_gt.theta_deg, i2Ti1.theta_deg)
            if verbose:
                print(f"\tPano pair ({i1},{i2}): GT {i2Ti1_gt.theta_deg:.1f} vs. {i2Ti1.theta_deg:.1f}")
            errs.append(err)
        return float(np.mean(errs)) if errs else float("nan")


def convert_Sim3_to_Sim2(a_Sim3_b: Sim3) -> Sim2:
    """Project a (near-planar) Sim(3) to Sim(2), validating out-of-plane terms."""
    a_Rot2_b = a_Sim3_b.R[:2, :2]
    theta_deg = rotmat2theta_deg(a_Rot2_b)
    # The transform must be a rotation about +z (planar graphs guarantee this).
    rz = math.degrees(math.atan2(a_Sim3_b.R[1, 0], a_Sim3_b.R[0, 0]))
    assert np.isclose(rz, theta_deg, atol=0.1)
    assert abs(a_Sim3_b.R[2, 0]) < 1e-3 and abs(a_Sim3_b.R[2, 1]) < 1e-3
    return Sim2(R=a_Rot2_b, t=a_Sim3_b.t[:2], s=a_Sim3_b.s)


def get_gt_pose_graph(building_id: str, floor_id: str, raw_dataset_dir: str) -> PoseGraph2d:
    """Load the GT pose graph for one floor from ZInD `merger` annotations.

    Missing floor scales are imputed from the building's other floors, falling
    back to the ZInD-wide average (parity: salve/common/posegraph2d.py:531).
    """
    json_annot_fpath = f"{raw_dataset_dir}/{building_id}/zind_data.json"
    floor_map_json = io_utils.read_json_file(json_annot_fpath)
    if "merger" not in floor_map_json:
        raise ValueError(f"Building {building_id} missing `merger` data.")
    merger_data = floor_map_json["merger"]
    if floor_id not in merger_data:
        raise ValueError(f"Invalid floor {floor_id} specified for ZInD Building {building_id}.")

    scale_dict = floor_map_json["scale_meters_per_coordinate"]
    scale = scale_dict[floor_id]
    if scale is None:
        valid_scales = [v for v in scale_dict.values() if v is not None]
        scale = float(np.mean(valid_scales)) if valid_scales else ZIND_AVERAGE_SCALE_METERS_PER_COORDINATE

    fd = FloorData.from_json(merger_data[floor_id], floor_id)
    return PoseGraph2d.from_floor_data(
        building_id=building_id, fd=fd, scale_meters_per_coordinate=scale
    )


def compute_available_floors_for_building(building_id: str, raw_dataset_dir: str) -> List[str]:
    """List floor IDs present in a building's `merger` annotations."""
    floor_map_json = io_utils.read_json_file(f"{raw_dataset_dir}/{building_id}/zind_data.json")
    if "merger" not in floor_map_json:
        raise ValueError(f"Building {building_id} missing `merger` data.")
    return list(floor_map_json["merger"].keys())
