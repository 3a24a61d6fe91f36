"""The port's jax-free stitching copies, each held to its salve_tpu original
on the same seeded inputs: exactly (tolerance: none; they are the same numpy
and math code), including the loaders' dict orders.

Also the seeded stitching inputs (`dataset/seeded_stitching.py`): the
functions that read each field recover the true room from it.
"""

import json
import math
import pathlib

import numpy as np
import pytest

from salve_tpu.dataset import salve_sfm_result_loader as jsfm_loader
from salve_tpu.stitching import constants as jconstants
from salve_tpu.stitching import draw as jdraw
from salve_tpu.stitching import floor_map as jfloor_map
from salve_tpu.stitching import ground_truth_utils as jgt
from salve_tpu.stitching import loaders as jloaders
from salve_tpu.stitching import models as jmodels
from salve_tpu.stitching import shape as jshape
from salve_tpu.stitching import transform as jtransform
from salve_tpu.stitching import utilities as jutilities
from salve_tpu_torch.dataset import procedural, salve_sfm_result_loader, seeded_stitching
from salve_tpu_torch.geometry.pano_projection import pixel_to_worldmetric
from salve_tpu_torch.geometry.polygons import points_in_polygon
from salve_tpu_torch.stitching import (
    constants,
    draw,
    floor_map,
    ground_truth_utils,
    loaders,
    models,
    shape,
    transform,
    utilities,
)


def _pt(mod, xy):
    return mod.Point2d(x=float(xy[0]), y=float(xy[1]))


def _xy(p):
    return None if p is None else (p.x, p.y)


RNG = np.random.default_rng(11)
POINTS = RNG.uniform(-3, 3, (12, 2))
UVS = np.column_stack([RNG.uniform(0, 1, 12), RNG.uniform(0.52, 0.95, 12)])
POSES = [(RNG.uniform(-2, 2), RNG.uniform(-2, 2), RNG.uniform(-180, 180)) for _ in range(4)]


def test_constants_equal():
    names = [n for n in dir(jconstants) if n.isupper()]
    assert names and all(getattr(constants, n) == getattr(jconstants, n) for n in names)


def test_models_equal():
    a, b = POINTS[0], POINTS[1]
    assert _pt(models, a).distance(_pt(models, b)) == _pt(jmodels, a).distance(_pt(jmodels, b))
    with pytest.raises(ValueError):
        _pt(models, a).distance(a)
    for x, y, rot in POSES:
        f, jf = models.Feature2dXy.fromPoint2d(_pt(models, a), "door"), jmodels.Feature2dXy.fromPoint2d(_pt(jmodels, a), "door")
        pose, jpose = (m.Pose(position=m.Point2d(x=x, y=y), rotation=rot) for m in (models, jmodels))
        for g, jg in ((f.project_to_camera_cartesian_by_camera_pose(pose), jf.project_to_camera_cartesian_by_camera_pose(jpose)),
                      (f.apply_camera_pose_to_camera_cartesian(pose), jf.apply_camera_pose_to_camera_cartesian(jpose))):
            assert (g.u, g.depth, _xy(g.xy), g.feature_type) == (jg.u, jg.depth, _xy(jg.xy), jg.feature_type)
            assert _xy(g.uv(0.4)) == _xy(jg.uv(0.4))


def test_transform_point_functions_equal():
    h = constants.DEFAULT_CAMERA_HEIGHT
    for uv, xy in zip(UVS, POINTS):
        assert _xy(transform.uv_to_xy(_pt(models, uv), h)) == _xy(jtransform.uv_to_xy(_pt(jmodels, uv), h))
        p, jp = transform.uv_to_xyz(_pt(models, uv)), jtransform.uv_to_xyz(_pt(jmodels, uv))
        assert (p.x, p.y, p.z) == (jp.x, jp.y, jp.z)
        assert _xy(transform.u_to_xy(uv[0])) == _xy(jtransform.u_to_xy(uv[0]))
        assert transform.xy_to_u(_pt(models, xy)) == jtransform.xy_to_u(_pt(jmodels, xy))
        assert transform.xy_to_depth(_pt(models, xy)) == jtransform.xy_to_depth(_pt(jmodels, xy))
        assert _xy(transform.xy_to_uv(_pt(models, xy), h)) == _xy(jtransform.xy_to_uv(_pt(jmodels, xy), h))
        for x, y, rot in POSES:
            pose, jpose = (m.Pose(position=m.Point2d(x=x, y=y), rotation=rot) for m in (models, jmodels))
            assert _xy(transform.transform_xy_by_pose(_pt(models, xy), pose)) == \
                _xy(jtransform.transform_xy_by_pose(_pt(jmodels, xy), jpose))
            assert _xy(transform.project_xy_by_pose(_pt(models, xy), pose)) == \
                _xy(jtransform.project_xy_by_pose(_pt(jmodels, xy), jpose))
    assert transform.uv_to_xy_batch(UVS.tolist(), h) == jtransform.uv_to_xy_batch(UVS.tolist(), h)
    pts, jpts = [_pt(models, p) for p in POINTS], [_pt(jmodels, p) for p in POINTS]
    assert [_xy(p) for p in transform.rotate_xys_clockwise(pts, 33.0)] == \
        [_xy(p) for p in jtransform.rotate_xys_clockwise(jpts, 33.0)]


def test_transform_ray_casts_and_matrices_equal():
    ang = np.sort(RNG.uniform(0, 2 * np.pi, 9))
    ring = np.stack([2 * np.cos(ang), 1.5 * np.sin(ang)], -1)
    for u in np.linspace(0, 1, 23):
        assert _xy(transform.ray_cast_by_u(u, ring)) == _xy(jtransform.ray_cast_by_u(u, ring))
    assert transform.ray_cast_by_u(0.3, ring + 10) is None and jtransform.ray_cast_by_u(0.3, ring + 10) is None
    for k in range(0, 10, 2):
        segs = ((POINTS[k], POINTS[k + 1]), (POINTS[k + 1], POINTS[k + 2]))
        assert _xy(transform.line_segment_intersection(*segs)) == _xy(jtransform.line_segment_intersection(*segs))
        cross = ((POINTS[k], POINTS[k + 2]), (POINTS[k + 1], POINTS[k + 3]))
        assert _xy(transform.line_segment_intersection(*cross)) == _xy(jtransform.line_segment_intersection(*cross))
    assert [_xy(p) for p in transform.ray_cast_and_generate_dwo_xy([0.1, 0.2], ring)] == \
        [_xy(p) for p in jtransform.ray_cast_and_generate_dwo_xy([0.1, 0.2], ring)]
    np.testing.assert_array_equal(transform.gen_homogeneous_transformation_matrix_for_2d([1, 2], 0.3, 1.5),
                                  jtransform.gen_homogeneous_transformation_matrix_for_2d([1, 2], 0.3, 1.5))
    args = ([0.5, -0.25], 1.0, 2.0, 35.0, 1.3)
    assert transform.get_global_coords_2d_from_room_cs(*args) == jtransform.get_global_coords_2d_from_room_cs(*args)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reproject_uvs_to_equal(seed):
    """The per-column resampling of another pano's boundary, on a dense
    shape seen from a moved pose (monotonic sections, wrap-around)."""
    rng = np.random.default_rng(seed)
    v = 330 + 40 * np.sin(np.linspace(0, 2 * np.pi, 1024) * (seed + 1)) + rng.normal(0, 2, 1024)
    unc = rng.uniform(1, 6, 1024).tolist()
    poly, conf = jshape.generate_dense_shape(v, unc)
    pose = jmodels.Pose(position=jmodels.Point2d(x=0.2, y=-0.1), rotation=40.0 * seed)
    ring = jshape.extract_coordinates_from_polygon(poly)  # closed: 513 points, as the fusion passes them
    uvs = [jtransform.xy_to_uv(jtransform.project_xy_by_pose(jtransform.transform_xy_by_pose(p, pose),
                                                              jmodels.ORIGIN_POSE), 0.4) for p in ring]
    puvs = [_pt(models, (q.x, q.y)) for q in uvs]
    got = transform.reproject_uvs_to(puvs, np.asarray(conf), "a", "b")
    want = jtransform.reproject_uvs_to(uvs, np.asarray(conf), "a", "b")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_utilities_equal():
    preds = {"wdo": [[[1, 0.9, 0.1, 0, 0.2], [2, 0.4, 0.3, 0, 0.35], [3, 0.7, 0.6, 0, 0.7]]]}
    got = utilities.get_dwo_edge_feature2ds_from_prediction(preds, 0.4)
    want = jutilities.get_dwo_edge_feature2ds_from_prediction(preds, 0.4)
    assert [[(f.u, f.feature_type) for f in pair] for pair in got] == \
        [[(f.u, f.feature_type) for f in pair] for pair in want]


def test_shape_host_helpers_equal():
    v = 330 + 30 * np.cos(np.linspace(0, 4 * np.pi, 1024))
    unc = list(np.linspace(1, 5, 1024))
    (p, d), (jp, jd) = shape.generate_dense_shape(v, unc), jshape.generate_dense_shape(v, unc)
    np.testing.assert_array_equal(p, jp)
    assert d == jd
    corners = RNG.uniform(0, 1, (10, 2)).tolist()
    np.testing.assert_array_equal(shape.load_room_shape_polygon_from_predictions(corners),
                                  jshape.load_room_shape_polygon_from_predictions(corners))
    verts = [{"x": float(x), "y": float(y)} for x, y in POINTS[:5]]
    np.testing.assert_array_equal(shape.generate_polygon_from_room_shape_vertices(verts),
                                  jshape.generate_polygon_from_room_shape_vertices(verts))
    assert [_xy(q) for q in shape.extract_coordinates_from_polygon(POINTS[:5])] == \
        [_xy(q) for q in jshape.extract_coordinates_from_polygon(POINTS[:5])]


@pytest.fixture(scope="module")
def cluster_inputs(tmp_path_factory):
    """The cluster flow's files for procedural floor 3, with its GT poses
    serialized as run_sfm serializes them (no Stage D run needed here)."""
    root = tmp_path_factory.mktemp("stitching_copies")
    building = procedural.generate_building_json(seed=3, n_rows=3, n_cols=3)
    panos = seeded_stitching._floor_panos(building)
    wSi = {str(p.id): {"R": p.global_Sim2_local.rotation.tolist(), "t": p.global_Sim2_local.translation.tolist(),
                       "s": p.global_Sim2_local.scale} for _, p in panos}
    ser = root / "0003__floor_01.json"
    ser.write_text(json.dumps({"building_id": "0003", "floor_id": "floor_01", "scale_meters_per_coordinate": 3.5,
                               "wSi_dict": wSi}))
    paths = seeded_stitching.write_cluster_inputs(root / "clusters", "0003", building, str(ser), 3)
    seeded_stitching.write_layout_predictions(root / "layouts", "0003", building, 3)
    return building, panos, ser, paths, root


def test_floor_map_and_ground_truth_alignment_equal(cluster_inputs):
    _, _, _, paths, _ = cluster_inputs
    fm = json.loads(pathlib.Path(paths["floor_map"]).read_text())
    a, b = floor_map.FloorMapObject(fm), jfloor_map.FloorMapObject(fm)
    assert (a.fsids, a.floor_ids_by_panoid, a.panoids_by_order) == (b.fsids, b.floor_ids_by_panoid, b.panoids_by_order)
    assert a.get_floor_shape_id_by_number(1) == b.get_floor_shape_id_by_number(1) is not None
    assert a.get_floor_map_scale() == b.get_floor_map_scale()
    for hid in fm["panos"]:
        p, q = a.get_pano_global_pose(hid), b.get_pano_global_pose(hid)
        assert (_xy(p.position), p.rotation) == (_xy(q.position), q.rotation)
    assert a.get_pano_global_pose("missing") is None
    for rsid in fm["room_shapes"]:
        np.testing.assert_array_equal(a.get_room_shape_global_ring(rsid), b.get_room_shape_global_ring(rsid))
        pose = models.Pose(position=models.Point2d(x=0.5, y=-1.0), rotation=20.0)
        jpose = jmodels.Pose(position=jmodels.Point2d(x=0.5, y=-1.0), rotation=20.0)
        assert a.get_room_shape_global(rsid, pose) == b.get_room_shape_global(rsid, jpose)
    assert a.get_panoids_with_floor_id("floor_shape_01") == b.get_panoids_with_floor_id("floor_shape_01")
    for cluster in json.loads(pathlib.Path(paths["clusters"]).read_text()):
        assert ground_truth_utils.align_pred_poses_with_gt(a, cluster) == jgt.align_pred_poses_with_gt(b, cluster)


def test_memory_loader_equal(cluster_inputs):
    _, _, _, paths, _ = cluster_inputs
    for kind in ({"rse": ["joint_madori_v1"], "dwo": ["rcnn"]}, {"rse": ["partial_v1"], "dwo": ["rcnn"]}):
        a, b = loaders.MemoryLoader(paths["pred_dir"], kind), jloaders.MemoryLoader(paths["pred_dir"], kind)
        assert a.pano_ids() == b.pano_ids() and len(a.pano_ids()) > 3
        for pid in a.pano_ids() + ["missingpano"]:
            assert a.get_room_shape_predictions(pid, kind["rse"][0]) == b.get_room_shape_predictions(pid, kind["rse"][0])
            assert a.get_dwo_predictions(pid) == b.get_dwo_predictions(pid)
    with pytest.raises(Exception, match="InternalImplementationError"):
        loaders.MemoryLoader(paths["pred_dir"], {"rse": [], "dwo": ["rcnn"]})


@pytest.mark.parametrize("kind", ["NONE", "HNET_CORNERS", "HNET_DENSE"])
def test_sfm_result_loader_equal(cluster_inputs, tmp_path, kind):
    building, _, ser, _, root = cluster_inputs
    (tmp_path / "0003").mkdir()
    (tmp_path / "0003" / "zind_data.json").write_text(json.dumps(building))
    a = salve_sfm_result_loader.load_estimated_pose_graph(
        ser, salve_sfm_result_loader.EstimatedBoundaryType[kind], str(tmp_path), str(root / "layouts"))
    b = jsfm_loader.load_estimated_pose_graph(ser, jsfm_loader.EstimatedBoundaryType[kind], str(tmp_path),
                                              str(root / "layouts"))
    assert (a.building_id, a.floor_id, a.scale_meters_per_coordinate) == (b.building_id, b.floor_id,
                                                                          b.scale_meters_per_coordinate)
    assert list(a.nodes) == list(b.nodes)
    for i in a.nodes:
        np.testing.assert_array_equal(a.nodes[i].room_vertices_global_2d, b.nodes[i].room_vertices_global_2d)
    with pytest.raises(ValueError):
        salve_sfm_result_loader.load_estimated_pose_graph(str(ser))


class _Axis:
    """Records what a matplotlib axis is asked to draw."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args, **kwargs: self.calls.append(
            (name, [np.asarray(a).tolist() if isinstance(a, np.ndarray) else a for a in args], kwargs))


def test_draw_helpers_equal():
    shape_pts = [_pt(models, p) for p in POINTS[:6]]
    jshape_pts = [_pt(jmodels, p) for p in POINTS[:6]]
    pose, jpose = models.Pose(position=models.Point2d(x=1, y=2), rotation=30), \
        jmodels.Pose(position=jmodels.Point2d(x=1, y=2), rotation=30)
    a, b = _Axis(), _Axis()
    for mod, ax, pts, p in ((draw, a, shape_pts, pose), (jdraw, b, jshape_pts, jpose)):
        mod.draw_shape_in_top_down_canvas(ax, pts, "black", pose=p)
        mod.draw_shape_in_top_down_canvas_fill(ax, pts, (0.1, 0.2, 0.3), pose=p)
        mod.draw_camera_in_top_down_canvas(ax, p, "blue")
        mod.draw_dwo_in_top_down_canvas(ax, pts[0], pts[1], "red", pose=p)
        mod.draw_dwo_xy_top_down_canvas(ax, None, None, {"x": [(pts[0], pts[1], "door")]})
    assert a.calls == b.calls and len(a.calls) == 6
    assert draw.TANGO_COLOR_PALETTE == jdraw.TANGO_COLOR_PALETTE


def test_seeded_layouts_recover_the_rooms(cluster_inputs):
    """Each seeded field, read by its reader, gives back the true room: the
    dense boundary within the noise, the corners up to float64 rounding,
    and the stitching poses put the room where the ground truth has it (up
    to float32 rounding: ZInD's Sim(2) poses are float32)."""
    _, panos, _, paths, root = cluster_inputs
    fm = json.loads(pathlib.Path(paths["floor_map"]).read_text())
    for room_key, pano in panos:
        ring = pano.room_vertices_local_2d * pano.global_Sim2_local.scale
        hid = seeded_stitching.hex_pano_id("0003", pano.id)
        madori = json.loads((pathlib.Path(paths["pred_dir"]) / hid / "rmx-madori-v1_predictions.json").read_text())
        rs = madori[0]["predictions"]["room_shape"]
        np.testing.assert_allclose(shape.load_room_shape_polygon_from_predictions(rs["corners_in_uv"]), ring, atol=1e-9)
        dense, _ = shape.generate_dense_shape(rs["raw_predictions"]["floor_boundary"],
                                              rs["raw_predictions"]["floor_boundary_uncertainty"])
        inside = points_in_polygon(ring * 1.15, dense)
        assert inside.mean() > 0.95
        assert min(rs["raw_predictions"]["floor_boundary_uncertainty"]) > 0
        x, y, rot = seeded_stitching.stitching_pose(pano.global_Sim2_local)
        rec = fm["room_shapes"][room_key.replace("/", "__")]["panos"][hid]
        assert (rec["position"]["x"], rec["position"]["y"], rec["rotation"]) == (x, y, rot)
        pose = models.Pose(position=models.Point2d(x=x, y=y), rotation=rot)
        world = np.array([_xy(transform.transform_xy_by_pose(_pt(models, p), pose)) for p in ring])
        np.testing.assert_allclose(world, pano.room_vertices_global_2d, atol=1e-6)
        hn = json.loads(next((root / "layouts" / "horizon_net" / "0003").glob(
            f"*_{pano.id}.json")).read_text())["predictions"]["room_shape"]["corners_in_uv"]
        uv = np.array(hn)[1::2] * [1024, 512]
        np.testing.assert_allclose(pixel_to_worldmetric(uv, 1024, 1.0)[:, :2], pano.room_vertices_local_2d, atol=1e-9)
    assert math.isclose(fm["floor_shapes"]["floor_shape_01"]["scale"], 3.5)
