"""The port's jax-free copies on Stage D's path, each held to its salve_tpu
original on the same seeded inputs: exactly (they are the same numpy code),
orders of dicts, sets and lists included, since Stage D's poses follow them.

Inputs: procedural floors through the GT-mode exporter with seeded
predictions (`test_torch_stage_d.make_stage_d_inputs`); the MHNet-based ones
(data association, vanishing-angle alignment) through the inferred-mode
exporter on seeded MHNet predictions.
"""

import copy

import numpy as np
import pytest

from salve_tpu.algorithms import cluster_merging as jcluster_merging
from salve_tpu.algorithms import cycle_consistency as jcycle_consistency
from salve_tpu.algorithms import data_association as jdata_association
from salve_tpu.algorithms import global_local_consistency as jglc
from salve_tpu.algorithms import rotation_averaging as jrotation_averaging
from salve_tpu.algorithms import spanning_tree as jspanning_tree
from salve_tpu.common import edge_classification as jedge_classification
from salve_tpu.common import posegraph2d as jposegraph2d
from salve_tpu.common.edgewdopair import EdgeWDOPair as JaxEdgeWDOPair
from salve_tpu.common.two_view_estimation_report import TwoViewEstimationReport as JaxReport
from salve_tpu.dataset import hnet_prediction_loader as jloader
from salve_tpu.geometry.pose2 import Pose2 as JaxPose2
from salve_tpu.geometry.pose2 import wrap_to_pi as jwrap_to_pi
from salve_tpu.training import meters as jmeters
from salve_tpu.utils import axis_alignment as jaxis_alignment
from salve_tpu.utils import graph_utils as jgraph_utils
from salve_tpu.utils import iou_utils as jiou_utils
from salve_tpu.utils import pr_utils as jpr_utils
from salve_tpu.utils import profiler as jprofiler
from salve_tpu_torch.algorithms import (
    cluster_merging,
    cycle_consistency,
    data_association,
    global_local_consistency,
    rotation_averaging,
    spanning_tree,
)
from salve_tpu_torch.common import edge_classification, posegraph2d
from salve_tpu_torch.common.edgewdopair import EdgeWDOPair
from salve_tpu_torch.common.two_view_estimation_report import TwoViewEstimationReport
from salve_tpu_torch.dataset import hnet_prediction_loader as loader
from salve_tpu_torch.geometry.pose2 import Pose2, wrap_to_pi
from salve_tpu_torch.training import meters
from salve_tpu_torch.utils import axis_alignment, graph_utils, iou_utils, pr_utils, profiler

from test_torch_bev_pairs import listing_sorted
from test_torch_stage_d import FLOORS, WDO_TYPES, make_stage_d_inputs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _sim2(a, b):
    assert a.rotation.tobytes() == b.rotation.tobytes()
    assert a.translation.tobytes() == b.translation.tobytes()
    assert a.scale == b.scale


def _sim2_dicts(got, want):
    assert list(got) == list(want)
    for k in got:
        _sim2(got[k], want[k])


def _pose_lists(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            _sim2(g, w)


class Floor:
    """One floor's Stage D inputs parsed by both packages."""

    def __init__(self, inputs, building_id, floor_id="floor_01"):
        args = dict(query_building_id=building_id, query_floor_id=floor_id,
                    serialized_preds_json_dir=inputs["preds"], hypotheses_save_root=inputs["hyp"],
                    allowed_wdo_types=WDO_TYPES)
        self.ms = edge_classification.get_edge_classifications_from_serialized_preds(**args)[(building_id, floor_id)]
        self.jms = listing_sorted(jedge_classification.get_edge_classifications_from_serialized_preds)(**args)[
            (building_id, floor_id)]
        self.gt = posegraph2d.get_gt_pose_graph(building_id, floor_id, inputs["raw"])
        self.jgt = jposegraph2d.get_gt_pose_graph(building_id, floor_id, inputs["raw"])
        self.hi = edge_classification.get_conf_thresholded_edge_measurements(self.ms, 0.93)
        self.jhi = jedge_classification.get_conf_thresholded_edge_measurements(self.jms, 0.93)
        self.most = edge_classification.get_most_likely_relative_pose_per_edge(self.hi, self.gt)
        self.jmost = jedge_classification.get_most_likely_relative_pose_per_edge(self.jhi, self.jgt)
        pool = edge_classification.get_conf_thresholded_edge_measurements(self.ms, 0.5)
        jpool = jedge_classification.get_conf_thresholded_edge_measurements(self.jms, 0.5)
        self.pool = edge_classification.get_most_likely_relative_pose_per_edge(pool, self.gt)
        self.jpool = jedge_classification.get_most_likely_relative_pose_per_edge(jpool, self.jgt)
        self.layouts = {i: np.asarray(p.room_vertices_local_2d) for i, p in self.gt.nodes.items()}
        self.preds = inputs["preds"]
        self.hyp = inputs["hyp"]


@pytest.fixture(scope="module")
def floors(tmp_path_factory):
    inputs = make_stage_d_inputs(tmp_path_factory.mktemp("copies"), floors=FLOORS[:2])
    return [Floor(inputs, f"{seed:04d}") for seed, _ in FLOORS[:2]]


@pytest.fixture(scope="module")
def inferred(tmp_path_factory):
    inputs = make_stage_d_inputs(tmp_path_factory.mktemp("copies_inferred"), floors=FLOORS[:1], inferred=True)
    floor = Floor(inputs, "0000")
    floor.inferred = loader.load_inferred_floor_pose_graph("0000", "floor_01", inputs["raw"], inputs["mhnet"])
    floor.jinferred = jloader.load_inferred_floor_pose_graph("0000", "floor_01", inputs["raw"], inputs["mhnet"])
    return floor


def test_edge_classification_copy(floors):
    fields = ("i1", "i2", "prob", "y_hat", "y_true", "pair_idx", "wdo_pair_uuid", "configuration",
              "building_id", "floor_id")
    for f in floors:
        assert len(f.ms) > 300 and len(f.hi) > 20
        # glob order is the file system's: compare as sorted lists.
        key = lambda m: (m.i1, m.i2, m.wdo_pair_uuid, m.configuration)  # noqa: E731
        for m, j in zip(sorted(f.ms, key=key), sorted(f.jms, key=key)):
            assert [getattr(m, k) for k in fields] == [getattr(j, k) for k in fields]
            _sim2(m.i2Si1, j.i2Si1)
            assert m.compute_measurement_relative_pose_error_from_gt(f.gt) == \
                j.compute_measurement_relative_pose_error_from_gt(f.jgt)
        assert [key(m) for m in f.hi] == [key(m) for m in f.jhi]
        for (a, b) in ((f.most, f.jmost), (f.pool, f.jpool)):
            _sim2_dicts(a[0], b[0])
            assert list(a[1]) == list(b[1]) and all(vars(a[1][k]) == vars(b[1][k]) for k in a[1])
            assert a[2] == {k: EdgeWDOPair(*v) for k, v in b[2].items()}
            assert list(a[3]) == list(b[3])
    preds = floors[0].preds
    assert sorted(edge_classification.get_available_floor_ids_building_ids_from_serialized_preds(preds)) == \
        sorted(jedge_classification.get_available_floor_ids_building_ids_from_serialized_preds(preds)) == \
        [("0000", "floor_01"), ("0001", "floor_01")]


def test_edge_classifications_do_not_follow_the_listing_order(floors, monkeypatch):
    """The port reads the batch files in sorted order: on a reversed listing
    it gives the same measurements in the same order."""
    import glob

    f = floors[0]
    building_id, floor_id = f.ms[0].building_id, f.ms[0].floor_id
    args = dict(query_building_id=building_id, query_floor_id=floor_id, serialized_preds_json_dir=f.preds,
                hypotheses_save_root=f.hyp, allowed_wdo_types=WDO_TYPES)
    key = lambda m: (m.i1, m.i2, m.pair_idx, m.wdo_pair_uuid, m.configuration, m.prob)  # noqa: E731
    want = [key(m) for m in edge_classification.get_edge_classifications_from_serialized_preds(**args)[
        (building_id, floor_id)]]
    listing = glob.glob
    monkeypatch.setattr(glob, "glob", lambda pattern, **kw: sorted(listing(pattern, **kw), reverse=True))
    got = [key(m) for m in edge_classification.get_edge_classifications_from_serialized_preds(**args)[
        (building_id, floor_id)]]
    assert got == want and len(glob.glob(f"{f.preds}/batch*.json")) > 1


def test_graph_utils_and_spanning_tree_copies(floors):
    for f in floors:
        for edges in (list(f.most[0]), list(f.pool[0])):
            nodes = list(f.gt.nodes)
            assert [list(c) for c in graph_utils.find_connected_components(edges, nodes)] == \
                [list(c) for c in jgraph_utils.find_connected_components(edges, nodes)]
            assert graph_utils.get_nodes_in_largest_connected_component(edges) == \
                jgraph_utils.get_nodes_in_largest_connected_component(edges)
            for a, b in zip(graph_utils.analyze_cc_distribution(nodes, edges),
                            jgraph_utils.analyze_cc_distribution(nodes, edges)):
                assert np.array_equal(a, b)
        got = spanning_tree.greedily_construct_st_Sim2(f.most[0])
        want = jspanning_tree.greedily_construct_st_Sim2(f.jmost[0])
        _pose_lists(got, want)
        assert spanning_tree.compute_hypothesis_errors(f.hi, got) == jspanning_tree.compute_hypothesis_errors(f.jhi, want)
        rots = {k: v.rotation for k, v in f.most[0].items()}
        for a, b in zip(spanning_tree.greedily_construct_st(rots), jspanning_tree.greedily_construct_st(rots)):
            assert (a is None and b is None) or a.tobytes() == b.tobytes()
        got, hyp = spanning_tree.ransac_spanning_trees(f.hi, 20, rng=np.random.default_rng(5))
        want, jhyp = jspanning_tree.ransac_spanning_trees(f.jhi, 20, rng=np.random.default_rng(5))
        _pose_lists(got, want)
        assert [(m.i1, m.i2, m.wdo_pair_uuid) for m in hyp] == [(m.i1, m.i2, m.wdo_pair_uuid) for m in jhyp]
        assert spanning_tree.compute_objective_function_improvement(1, 2, 0.5, 0.4, 10, 12) == \
            jspanning_tree.compute_objective_function_improvement(1, 2, 0.5, 0.4, 10, 12)
    with pytest.raises(ValueError):
        spanning_tree.ransac_spanning_trees([])


def test_rotation_averaging_cycle_and_global_local_consistency_copies(floors):
    for f in floors:
        rots = {k: v.rotation for k, v in f.pool[0].items()}
        for a, b in zip(rotation_averaging.globalaveraging2d(rots), jrotation_averaging.globalaveraging2d(rots)):
            assert (a is None and b is None) or a.tobytes() == b.tobytes()
        assert rotation_averaging.globalaveraging2d({}) is None
        _sim2_dicts(cycle_consistency.filter_to_SE2_cycle_consistent_edges(f.pool[0], f.pool[1]),
                    jcycle_consistency.filter_to_SE2_cycle_consistent_edges(f.jpool[0], f.jpool[1]))
        got = cycle_consistency.filter_to_rotation_cycle_consistent_edges(rots, two_view_reports_dict=f.pool[1])
        want = jcycle_consistency.filter_to_rotation_cycle_consistent_edges(rots, two_view_reports_dict=f.jpool[1])
        assert list(got) == list(want)
        triplets = cycle_consistency.extract_triplets(f.pool[0])
        assert triplets == jcycle_consistency.extract_triplets(f.jpool[0]) and len(triplets) > 5
        for t in triplets[:10]:
            assert cycle_consistency.compute_SE2_cycle_error(f.pool[0], t) == \
                jcycle_consistency.compute_SE2_cycle_error(f.jpool[0], t)
            assert cycle_consistency.compute_rot_cycle_error(rots, t, f.pool[1]) == \
                jcycle_consistency.compute_rot_cycle_error(rots, t, f.jpool[1])
        _sim2_dicts(global_local_consistency.filter_measurements_by_global_local_consistency(f.pool[0], f.pool[1]),
                    jglc.filter_measurements_by_global_local_consistency(f.jpool[0], f.jpool[1]))
        wSi = spanning_tree.greedily_construct_st_Sim2(f.most[0])
        jwSi = jspanning_tree.greedily_construct_st_Sim2(f.jmost[0])
        assert global_local_consistency.compute_edge_consistency_fraction(wSi, f.pool[0], 5.0) == \
            jglc.compute_edge_consistency_fraction(jwSi, f.jpool[0], 5.0)


def test_cluster_merging_copy(floors):
    rescued = 0
    for f in floors:
        nodes = set(f.gt.nodes)
        cur, jcur = dict(f.most[0]), dict(f.jmost[0])
        while True:
            got = cluster_merging.merge_clusters(f.pool[0], cur, f.pool[1], pano_layouts=f.layouts,
                                                 all_nodes=nodes, min_conf=0.5)
            want = jcluster_merging.merge_clusters(f.jpool[0], jcur, f.jpool[1], pano_layouts=f.layouts,
                                                   all_nodes=nodes, min_conf=0.5)
            assert (got is None) == (want is None)
            if got is None:
                break
            _sim2_dicts(got, want)
            cur, jcur = got, want
            rescued += 1
        assert cluster_merging.merge_clusters(f.pool[0], f.most[0], f.pool[1]) is not None or \
            jcluster_merging.merge_clusters(f.jpool[0], f.jmost[0], f.jpool[1]) is None
        got, dropped = cluster_merging.resolve_penetration_conflicts(
            f.most[0], f.most[1], f.layouts, f.pool[0], f.pool[1], all_nodes=nodes)
        want, jdropped = jcluster_merging.resolve_penetration_conflicts(
            f.jmost[0], f.jmost[1], f.layouts, f.jpool[0], f.jpool[1], all_nodes=nodes)
        _sim2_dicts(got, want)
        assert dropped == jdropped
        wSi = spanning_tree.greedily_construct_st_Sim2(f.most[0])
        jwSi = jspanning_tree.greedily_construct_st_Sim2(f.jmost[0])
        assert cluster_merging.count_composite_violations(wSi, f.layouts) == \
            jcluster_merging.count_composite_violations(jwSi, f.layouts)
        assert cluster_merging.pool_support(wSi, f.pool[0]) == jcluster_merging.pool_support(jwSi, f.jpool[0])
        assert [list(c) for c in cluster_merging.get_connected_components(f.most[0])] == \
            [list(c) for c in jcluster_merging.get_connected_components(f.jmost[0])]
    assert rescued > 0


def test_data_association_copy(floors, inferred):
    # On the MHNet layouts the inferred-mode hypotheses came from, and on the
    # GT layouts of the GT-mode ones.
    for f, layouts, jlayouts in ((inferred, inferred.inferred, inferred.jinferred), (floors[0], floors[0].gt,
                                                                                        floors[0].jgt)):
        tracks = data_association.perform_data_association(f.hi, f.most[2], layouts)
        jtracks = jdata_association.perform_data_association(f.jhi, f.jmost[2], jlayouts)
        assert tracks == jtracks and len(tracks) > 2
        for track in tracks:
            for pano_id, kpt in track:
                a = data_association.get_kpt_coordinate(layouts.nodes[pano_id], kpt)
                b = jdata_association.get_kpt_coordinate(jlayouts.nodes[pano_id], kpt)
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_axis_alignment_copy(floors):
    """Vanishing angles near each pano's GT orientation, so most corrections
    are under the 15 degree cap and the pair is refit."""
    f = floors[0]
    rng = np.random.default_rng(9)
    graphs = (copy.deepcopy(f.gt), copy.deepcopy(f.jgt))
    for i in f.gt.nodes:
        vp = f.gt.nodes[i].global_Sim2_local.theta_deg + rng.uniform(-3, 3)
        for g in graphs:
            g.nodes[i].vanishing_angle_deg = vp
    got = axis_alignment.align_pairs_by_vanishing_angle(dict(f.most[0]), graphs[0], f.most[2])
    want = jaxis_alignment.align_pairs_by_vanishing_angle(dict(f.jmost[0]), graphs[1], f.jmost[2])
    assert list(got) == list(want)
    for k in got:
        # A float32 Sim(3) fit on both sides (torch CPU against XLA CPU).
        np.testing.assert_allclose(got[k].rotation, want[k].rotation, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[k].translation, want[k].translation, rtol=0, atol=1e-5)
    assert sum(not np.array_equal(got[k].rotation, f.most[0][k].rotation) for k in got) > len(got) // 2
    pts = rng.normal(size=(40, 2)) @ np.array([[3, 0.4], [0.4, 1]])
    assert axis_alignment.get_dominant_direction_from_point_cloud(pts) == \
        jaxis_alignment.get_dominant_direction_from_point_cloud(pts)


def test_small_copies():
    rng = np.random.default_rng(2)
    for x, y, th, x2, y2, th2 in rng.uniform(-4, 4, (10, 6)):
        a, b, ja, jb = Pose2(x, y, th), Pose2(x2, y2, th2), JaxPose2(x, y, th), JaxPose2(x2, y2, th2)
        assert tuple(a.compose(b)) == tuple(ja.compose(jb)) and tuple(a.inverse()) == tuple(ja.inverse())
        assert tuple(a.between(b)) == tuple(ja.between(jb)) and wrap_to_pi(th * 3) == jwrap_to_pi(th * 3)
        p = rng.normal(size=(5, 2))
        assert a.transform_from(p).tobytes() == ja.transform_from(p).tobytes()
        assert tuple(Pose2.from_theta_deg(th * 40, x, y)) == tuple(JaxPose2.from_theta_deg(th * 40, x, y))
    assert EdgeWDOPair.from_wdo_pair_uuid(3, 7, "door_2_1") == tuple(JaxEdgeWDOPair.from_wdo_pair_uuid(3, 7, "door_2_1"))
    assert vars(TwoViewEstimationReport(1, 2.0, 0.1, 0.9)) == vars(JaxReport(1, 2.0, 0.1, 0.9))

    m1, m2 = rng.uniform(size=(2, 30, 30)) > 0.5
    assert iou_utils.binary_mask_iou(m1, m2) == jiou_utils.binary_mask_iou(m1, m2)
    f1, f2 = rng.uniform(size=(2, 20, 20, 3))
    assert iou_utils.texture_map_iou(f1, f2) == jiou_utils.texture_map_iou(f1, f2)
    y_true, y_hat = rng.integers(0, 2, 200), rng.integers(0, 2, 200)
    assert pr_utils.compute_precision_recall(y_true, y_hat) == jpr_utils.compute_precision_recall(y_true, y_hat)
    assert pr_utils.compute_tp_fp_fn_tn_counts(y_true, y_hat) == jpr_utils.compute_tp_fp_fn_tn_counts(y_true, y_hat)
    pr, jpr = meters.PrecisionRecallMeter(), jmeters.PrecisionRecallMeter()
    seg, jseg = meters.SegmentationAverageMeter(), jmeters.SegmentationAverageMeter()
    for k in range(0, 200, 50):
        pr.update(y_true[k:k + 50], y_hat[k:k + 50])
        jpr.update(y_true[k:k + 50], y_hat[k:k + 50])
        pred, target = rng.integers(0, 3, (2, 8, 8))
        seg.update_metrics(pred, target, 3)
        jseg.update_metrics(pred, target, 3)
    assert pr.get_metrics() == jpr.get_metrics()
    for a, b in zip(seg.get_metrics(), jseg.get_metrics()):
        np.testing.assert_array_equal(a, b)

    profiler.reset_stage_timers()
    jprofiler.reset_stage_timers()
    for mod in (profiler, jprofiler):
        mod.record_stage("a", 0.5)
        mod.record_stage("a", 1.5)
        mod.record_stage("b", 2.0)
    assert profiler.stage_summary() == jprofiler.stage_summary()
    with profiler.stage_timer("c"), profiler.annotate("region"):
        pass
    assert profiler.stage_summary()["c"]["count"] == 1
    profiler.reset_stage_timers()
    assert profiler.stage_summary() == {}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with profiler.device_trace(str(tmp_path / "trace")):
        with profiler.annotate("stage_d/lm"):
            torch.ones(4).sum()
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert "stage_d/lm" in text
    with profiler.device_trace(None):
        pass
