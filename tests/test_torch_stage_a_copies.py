"""The port's jax-free copies on Stage A's path, each held equal to its
salve_tpu original on seeded inputs (exactly: they are the same numpy code).

MHNet predictions: the seam-merge cases are the reference's own
(tests/dataset/test_mhnet_prediction.py); the prediction parse and the
loader chain run on seeded prediction files, as no real ones ship here.
"""

import json

import numpy as np
import pytest

from salve_tpu.common import alignment_hypothesis as jah
from salve_tpu.common import posegraph2d as jposegraph2d
from salve_tpu.common.pano_data import FloorData as JaxFloorData
from salve_tpu.dataset import hnet_prediction_loader as jloader
from salve_tpu.dataset import mhnet_prediction as jmhnet
from salve_tpu.dataset import zind_partition as jzind_partition
from salve_tpu.geometry import pano_projection as jproj
from salve_tpu.geometry import polygons as jpolygons
from salve_tpu.geometry import polylines as jpolylines
from salve_tpu.geometry import poses as jposes
from salve_tpu.geometry import rotations as jrotations
from salve_tpu.geometry import simplify as jsimplify
from salve_tpu.geometry.sim2 import Sim2 as JaxSim2
from salve_tpu.hypotheses import wdo_alignment as jwdo_alignment
from salve_tpu.utils import io as jio
from salve_tpu_torch.common import alignment_hypothesis as ah
from salve_tpu_torch.common import posegraph2d
from salve_tpu_torch.common.pano_data import FloorData
from salve_tpu_torch.dataset import hnet_prediction_loader as loader
from salve_tpu_torch.dataset import mhnet_prediction as mhnet
from salve_tpu_torch.dataset import procedural, zind_partition
from salve_tpu_torch.geometry import pano_projection as proj
from salve_tpu_torch.geometry import polygons, polylines, poses, rotations, simplify
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.hypotheses import wdo_alignment
from salve_tpu_torch.utils import io

from test_torch_stage_a import _write_building, _write_predictions


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _floor(seed, **kwargs):
    b = procedural.generate_building_json(seed=seed, **kwargs)
    floor = b["merger"]["floor_01"]
    return FloorData.from_json(floor, "floor_01"), JaxFloorData.from_json(floor, "floor_01")


def test_rotations_copy():
    rng = np.random.default_rng(0)
    for a1, a2 in rng.uniform(-720, 720, (20, 2)):
        _same(rotations.rotmat2d(a1), jrotations.rotmat2d(a1))
        R = rotations.rotmat2d(a1)
        assert rotations.rotmat2theta_deg(R) == jrotations.rotmat2theta_deg(R)
        _same(rotations.rot2x2_to_3x3(R), jrotations.rot2x2_to_3x3(R))
        assert rotations.wrap_angle_deg(a1, a2) == jrotations.wrap_angle_deg(a1, a2)
        assert rotations.angle_is_equal(a1, a2, 90.0) == jrotations.angle_is_equal(a1, a2, 90.0)
        pts, c = rng.normal(size=(5, 2)), rng.normal(size=2)
        _same(rotations.rotate_polygon_about_pt(pts, R, c), jrotations.rotate_polygon_about_pt(pts, R, c))


def test_sim2_copy_is_whole(tmp_path):
    rng = np.random.default_rng(1)
    for _ in range(10):
        th, t, s = rng.uniform(-180, 180), rng.uniform(-3, 3, 2), rng.uniform(0.5, 2)
        th2, t2, s2 = rng.uniform(-180, 180), rng.uniform(-3, 3, 2), rng.uniform(0.5, 2)
        a, b = Sim2.from_theta_deg(th, t, s), Sim2.from_theta_deg(th2, t2, s2)
        ja, jb = JaxSim2.from_theta_deg(th, t, s), JaxSim2.from_theta_deg(th2, t2, s2)
        assert a.rotation.dtype == np.float32 and a.translation.dtype == np.float32
        for got, want in ((a.compose(b), ja.compose(jb)), (a.inverse(), ja.inverse()),
                          (Sim2.from_matrix(a.matrix), JaxSim2.from_matrix(ja.matrix))):
            _same(got.rotation, want.rotation)
            _same(got.translation, want.translation)
            assert got.scale == want.scale
        pts = rng.normal(size=(6, 2))
        _same(a.transform_from(pts), ja.transform_from(pts))
        _same(a.transform_point_cloud(pts), ja.transform_point_cloud(pts))
        assert a.theta_deg == ja.theta_deg and repr(a) == repr(ja)
        _same(a.matrix, ja.matrix)
        assert hash(a) == hash(ja)
        assert a == Sim2(a.rotation + 1e-9, a.translation, a.scale) and a != b and a != "a"
        a.save_as_json(tmp_path / "p" / "a.json")
        ja.save_as_json(tmp_path / "r" / "a.json")
        assert (tmp_path / "p" / "a.json").read_bytes() == (tmp_path / "r" / "a.json").read_bytes()
        back = Sim2.from_json(tmp_path / "p" / "a.json")
        _same(back.rotation, a.rotation)
    _same(Sim2.identity().matrix, JaxSim2.identity().matrix)
    with pytest.raises(ZeroDivisionError):
        Sim2(np.eye(2), np.zeros(2), 0.0)


def test_polylines_polygons_simplify_copies():
    rng = np.random.default_rng(2)
    port_fd, ref_fd = _floor(3)
    for p, j in zip(port_fd.panos, ref_fd.panos):
        poly = p.room_vertices_local_2d
        q = rng.uniform(-3, 3, (40, 2))
        _same(polygons.points_in_polygon(poly, q), jpolygons.points_in_polygon(poly, q))
        _same(polygons.distance_to_boundary(poly, q), jpolygons.distance_to_boundary(poly, q))
        assert polygons.polygon_area(poly) == jpolygons.polygon_area(poly)
        assert polygons.shrink_distance_for_polygon(poly, 0.1) == jpolygons.shrink_distance_for_polygon(poly, 0.1)
        other = p.room_vertices_local_2d + rng.uniform(-0.5, 0.5, 2)
        assert polygons.determine_invalid_wall_overlap(poly, other, 0.1) == \
            jpolygons.determine_invalid_wall_overlap(poly, other, 0.1)
        assert polygons.polygon_iou_and_overlap(poly, other, 0.05) == \
            jpolygons.polygon_iou_and_overlap(poly, other, 0.05)
        ring = np.vstack([poly, poly[:1]])
        assert polylines.get_polyline_length(ring) == jpolylines.get_polyline_length(ring)
        _same(polylines.interp_evenly_spaced_points(ring, 0.1), jpolylines.interp_evenly_spaced_points(ring, 0.1))
        _same(polylines.interp_arc(50, ring), jpolylines.interp_arc(50, ring))
    noisy = np.cumsum(rng.normal(size=(200, 2)), axis=0)
    for eps in (0.02, 0.5, 2.0):
        _same(simplify.rdp(noisy, eps), jsimplify.rdp(noisy, eps))


def test_poses_copy():
    rng = np.random.default_rng(3)
    R2, t2 = rotations.rotmat2d(rng.uniform(-180, 180)), rng.normal(size=2)
    a, ja = poses.Pose3.from_rot2_trans2(R2, t2), jposes.Pose3.from_rot2_trans2(R2, t2)
    b = poses.Pose3.from_rot2_trans2(rotations.rotmat2d(40.0), np.ones(2))
    jb = jposes.Pose3(b.R, b.t)
    for got, want in ((a.compose(b), ja.compose(jb)), (a.inverse(), ja.inverse())):
        _same(got.R, want.R)
        _same(got.t, want.t)
    S, jS = poses.Sim3(b.R, b.t, 1.7), jposes.Sim3(b.R, b.t, 1.7)
    _same(S.transform_pose(a).t, jS.transform_pose(ja).t)
    _same(S.transform_point(t2.tolist() + [0.0]), jS.transform_point(t2.tolist() + [0.0]))
    assert poses.rotation_angle_deg(a.R, b.R) == jposes.rotation_angle_deg(ja.R, jb.R)
    _same(poses.Sim3.identity().R, jposes.Sim3.identity().R)


def test_wdo_pano_data_and_alignment_hypothesis_copies():
    port_fd, ref_fd = _floor(11)
    assert [p.id for p in port_fd.panos] == [p.id for p in ref_fd.panos]
    for p, j in zip(port_fd.panos, ref_fd.panos):
        _same(p.room_vertices_global_2d, j.room_vertices_global_2d)
        assert (p.image_path, p.label) == (j.image_path, j.label)
        assert len(p.all_wdos) == len(j.all_wdos)
        for w, jw in zip(p.all_wdos, j.all_wdos):
            assert (w.pt1, w.pt2, w.bottom_z, w.top_z, w.type) == (jw.pt1, jw.pt2, jw.bottom_z, jw.top_z, jw.type)
            for attr in ("centroid", "width", "vertices_local_2d", "vertices_global_2d", "vertices_local_3d",
                         "polygon_vertices_local_3d"):
                _same(getattr(w, attr), getattr(jw, attr))
            _same(w.get_wd_normal_2d(), jw.get_wd_normal_2d())
            _same(w.get_rotated_version().polygon_vertices_local_3d, jw.get_rotated_version().polygon_vertices_local_3d)
            S = Sim2.from_theta_deg(30.0, np.array([0.5, -1.0]), 1.2)
            jS = JaxSim2.from_theta_deg(30.0, np.array([0.5, -1.0]), 1.2)
            _same(w.transform_from(S).vertices_local_2d, jw.transform_from(jS).vertices_local_2d)
            _same(w.apply_Sim2(S, 1.3).vertices_global_2d, jw.apply_Sim2(jS, 1.3).vertices_global_2d)

    # prune_to_unique_sim2_objs keeps the first of each group of duplicates.
    rng = np.random.default_rng(4)
    poses_ = [Sim2.from_theta_deg(float(th), rng.normal(size=2)) for th in rng.uniform(-180, 180, 5)]
    order = [0, 1, 0, 2, 1, 3, 4, 4, 2]
    hyps = [ah.AlignmentHypothesis(poses_[k], "door", n, k, "identity") for n, k in enumerate(order)]
    jhyps = [jah.AlignmentHypothesis(JaxSim2(h.i2Ti1.rotation, h.i2Ti1.translation, 1.0), *h[1:]) for h in hyps]
    got = ah.prune_to_unique_sim2_objs(hyps)
    assert [h.i1_wdo_idx for h in got] == [h.i1_wdo_idx for h in jah.prune_to_unique_sim2_objs(jhyps)]
    assert [h.i1_wdo_idx for h in got] == [0, 1, 3, 5, 6]


@pytest.mark.parametrize("transform_type", ["SE2", "Sim3"])
@pytest.mark.parametrize("inferred", [True, False])
def test_wdo_alignment_copy(transform_type, inferred):
    port_fd, ref_fd = _floor(2)
    P, J = {p.id: p for p in port_fd.panos}, {p.id: p for p in ref_fd.panos}
    ids = sorted(P)[: 5 if transform_type == "Sim3" else None]  # a JAX dispatch per Sim(3) fit
    n = 0
    for i1 in ids:
        for i2 in ids:
            if i1 >= i2:
                continue
            got, bad = wdo_alignment.align_rooms_by_wd(
                P[i1], P[i2], wdo_alignment.AlignTransformType(transform_type), inferred)
            want, jbad = jwdo_alignment.align_rooms_by_wd(
                J[i1], J[i2], jwdo_alignment.AlignTransformType(transform_type), inferred)
            assert bad == jbad
            assert [h[1:] for h in got] == [h[1:] for h in want]
            for h, jh in zip(got, want):
                tol = 0 if transform_type == "SE2" else 1e-5  # Sim(3): float32 SVD fits
                np.testing.assert_allclose(h.i2Ti1.rotation, jh.i2Ti1.rotation, rtol=0, atol=tol)
                np.testing.assert_allclose(h.i2Ti1.translation, jh.i2Ti1.translation, rtol=0, atol=tol)
                assert wdo_alignment.obj_almost_equal(h.i2Ti1, h.i2Ti1, h.wdo_alignment_object)
            n += len(got)
            assert wdo_alignment.are_visibly_adjacent(P[i1], P[i2]) == jwdo_alignment.are_visibly_adjacent(J[i1], J[i2])
    assert n > 20


def test_io_zind_partition_and_pano_projection_copies(tmp_path):
    data = {"a": [1, 2.5], "b": {"c": None}}
    io.save_json_file(tmp_path / "p" / "x.json", data)
    jio.save_json_file(tmp_path / "r" / "x.json", data)
    assert (tmp_path / "p" / "x.json").read_bytes() == (tmp_path / "r" / "x.json").read_bytes()
    assert io.read_json_file(tmp_path / "p" / "x.json") == data
    assert io.json_files_in_dir(tmp_path / "p") == jio.json_files_in_dir(tmp_path / "p")
    assert io.json_files_in_dir(tmp_path / "none") == []
    assert zind_partition.DATASET_SPLITS == jzind_partition.DATASET_SPLITS
    rng = np.random.default_rng(5)
    px = np.stack([rng.uniform(0, 1023, 100), rng.uniform(260, 511, 100)], -1)
    _same(proj.pixel_to_worldmetric(px, 1024, 1.3), jproj.pixel_to_worldmetric(px, 1024, 1.3))


def test_merge_wdos_straddling_img_border_cases():
    """The reference's seam-merge cases, port against salve_tpu."""
    cases = [
        [],
        [(0.14467253176930597, 0.3704789833822092), (0.45356793743890517, 0.46920821114369504),
         (0.47702834799608995, 0.5278592375366569), (0.5376344086021505, 0.5865102639296188),
         (0.6217008797653959, 0.8084066471163245)],
        [(0.0009775171065493646, 0.10361681329423265), (0.9354838709677419, 1.0)],
        [(0.3, 0.4)],
        [(0.005, 0.1), (0.5, 0.6), (0.95, 0.995)],
    ]
    for spans in cases:
        got = mhnet.merge_wdos_straddling_img_border([mhnet.MHNetDWO(s, e) for s, e in spans])
        want = jmhnet.merge_wdos_straddling_img_border([jmhnet.MHNetDWO(s, e) for s, e in spans])
        assert [(w.s, w.e) for w in got] == [(w.s, w.e) for w in want]
        assert isinstance(got, list)
    merged = mhnet.merge_wdos_straddling_img_border([mhnet.MHNetDWO(*s) for s in cases[2]])
    assert [(w.s, w.e) for w in merged] == [(0.9354838709677419, 0.10361681329423265)]
    with pytest.raises(RuntimeError):
        mhnet.MHNetDWO.from_json([0.1])


def test_prediction_loader_chain_copies(tmp_path, capsys):
    """MHNet JSON -> prediction -> PanoData -> per-floor pose graphs, and the
    GT pose graph helpers of posegraph2d."""
    raw, preds = tmp_path / "zind", tmp_path / "preds"
    building = procedural.generate_building_json(seed=4)
    _write_building(raw, "0004", building)
    _write_predictions(preds, "0004", building, 4)
    (preds / "vanishing_angle").mkdir()
    (preds / "vanishing_angle" / "0004.json").write_text(json.dumps([1.5, 2.5, 3.5]))

    got = loader.load_inferred_floor_pose_graphs("0004", str(raw), str(preds))
    want = jloader.load_inferred_floor_pose_graphs("0004", str(raw), str(preds))
    assert got.keys() == want.keys() == {"floor_01"}
    g, w = got["floor_01"], want["floor_01"]
    assert g.scale_meters_per_coordinate == w.scale_meters_per_coordinate
    assert sorted(g.nodes) == sorted(w.nodes) and len(g.nodes) >= 2
    for i in g.nodes:
        p, j = g.nodes[i], w.nodes[i]
        _same(p.room_vertices_local_2d, j.room_vertices_local_2d)
        assert (p.image_path, p.label, p.vanishing_angle_deg) == (j.image_path, j.label, j.vanishing_angle_deg)
        for kind in ("doors", "windows", "openings"):
            assert [(d.pt1, d.pt2) for d in getattr(p, kind)] == [(d.pt1, d.pt2) for d in getattr(j, kind)]
    assert loader.load_vanishing_angles(str(preds), "0004") == jloader.load_vanishing_angles(str(preds), "0004")
    assert loader.load_vanishing_angles(str(preds), "9999") == {}
    name = "x/panos/floor_02_partial_room_03_pano_13.jpg"
    assert loader.get_floor_id_from_img_fpath(name) == jloader.get_floor_id_from_img_fpath(name) == "floor_02"

    pred = next((preds / "horizon_net" / "0004").glob("*.json"))
    a = mhnet.MHNetPanoStructurePrediction.from_json_fpath(pred, pred.with_suffix(".jpg"))
    b = jmhnet.MHNetPanoStructurePrediction.from_json_fpath(pred, pred.with_suffix(".jpg"))
    _same(a.get_floor_corners_image(), b.get_floor_corners_image())
    _same(a.get_ceiling_corners_image(), b.get_ceiling_corners_image())

    gt = posegraph2d.get_gt_pose_graph("0004", "floor_01", str(raw))
    jgt = jposegraph2d.get_gt_pose_graph("0004", "floor_01", str(raw))
    assert posegraph2d.compute_available_floors_for_building("0004", str(raw)) == ["floor_01"]
    assert gt.pano_ids() == jgt.pano_ids() and repr(gt) == repr(jgt)
    i = gt.pano_ids()[0]
    assert gt.get_camera_height_m(i) == jgt.get_camera_height_m(i)
    gt.as_json(str(tmp_path / "p.json"))
    jgt.as_json(str(tmp_path / "r.json"))
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "r.json").read_bytes()
    assert posegraph2d.PoseGraph2d.from_json(str(tmp_path / "p.json")).pano_ids() == gt.pano_ids()
    for p3, j3 in zip(gt.as_3d_pose_graph(), jgt.as_3d_pose_graph()):
        assert (p3 is None) == (j3 is None)
        if p3 is not None:
            _same(p3.t, j3.t)
