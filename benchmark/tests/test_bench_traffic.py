"""The traffic generator: the same seed gives the same work, seeds differ
in content and not in sizes, and each mix has the counts its cell names."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import synthetic, traffic

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


# The mix of the dense-floor cell that PERF.md keeps for a later PR: floors of
# 24-32 panos, the verifier's share of the work.
DENSE = {"driver": "fused_scoring", "panos_per_floor": [24, 32], "hypotheses_per_pair": 9,
         "theta_deg": [-180.0, 180.0], "t_m": [-4.0, 4.0], "pool_panos": 48, "pano_hw": [512, 1024],
         "floors": 36, "trace_floors": 1, "reference_floors": 2, "reference_hypotheses": 128}


def mix(name):
    return DENSE if name == "dense" else json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["dense", "small_floors"])
def test_floors_repeat_for_a_seed_and_differ_across_seeds(name):
    m = mix(name)
    a, b, c = traffic.floors(m, 2**31 + 17), traffic.floors(m, 2**31 + 17), traffic.floors(m, 5)
    for x, y in zip(a, b):
        assert x.offset == y.offset and x.n_panos == y.n_panos
        np.testing.assert_array_equal(x.theta_deg, y.theta_deg)
        np.testing.assert_array_equal(x.t, y.t)
    assert any(not np.array_equal(x.theta_deg[:1], z.theta_deg[:1]) for x, z in zip(a, c))
    # Every seed gets the same multiset of floor sizes, in another order.
    assert sorted(f.n_panos for f in a) == sorted(f.n_panos for f in c)
    assert [f.n_panos for f in a] != [f.n_panos for f in c]


@pytest.mark.parametrize("name,lo,hi,mean", [("dense", 2484, 4464, None), ("small_floors", 27, 135, 76.5)])
def test_pano_and_hypothesis_counts(name, lo, hi, mean):
    m = mix(name)
    floors = traffic.floors(m, 3)
    p_lo, p_hi = m["panos_per_floor"]
    block = p_hi - p_lo + 1
    for k in range(0, len(floors) - block + 1, block):
        assert sorted(f.n_panos for f in floors[k:k + block]) == list(range(p_lo, p_hi + 1))
    for f in floors:
        assert f.n_hypotheses == 9 * f.n_panos * (f.n_panos - 1) // 2
        assert 0 <= f.offset <= m["pool_panos"] - f.n_panos
        assert np.all(f.pairs[:, 0] < f.pairs[:, 1]) and f.pairs.max() < f.n_panos
        assert np.all((f.theta_deg >= -180) & (f.theta_deg < 180)) and np.all(np.abs(f.t) <= 4)
    counts = [f.n_hypotheses for f in floors]
    assert min(counts) == lo and max(counts) == hi
    if mean is not None:
        assert np.mean(counts) == pytest.approx(mean)
    warm = traffic.warmup_floor(m, 3, 48)
    assert warm.n_panos == p_hi and warm.n_hypotheses == 48


def test_pano_pool_repeats_for_a_seed():
    d1, c1 = synthetic.pano_pool(3, 32, 64, 9)
    d2, c2 = synthetic.pano_pool(3, 32, 64, 9)
    d3, _ = synthetic.pano_pool(3, 32, 64, 10)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(c1, c2)
    assert not np.array_equal(d1, d3)
    assert d1.dtype == np.uint16 and c1.dtype == np.float32 and 0 <= c1.min() and c1.max() < 1


def test_corpus_rows_repeat_and_half_the_labels_are_positive():
    a = synthetic.corpus_chunk(4, 1, 8, (2, 5, 5, 3), "cpu")
    assert a.equal(synthetic.corpus_chunk(4, 1, 8, (2, 5, 5, 3), "cpu"))
    assert not a.equal(synthetic.corpus_chunk(4, 2, 8, (2, 5, 5, 3), "cpu"))
    labels = synthetic.corpus_labels(4, 8192)
    assert labels.sum() == 4096
    assert not np.array_equal(labels, synthetic.corpus_labels(5, 8192))
