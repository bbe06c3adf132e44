"""Order statistics, the union-of-intervals idle share with gaps named
by span, and the roofline byte count, on synthetic inputs."""
from __future__ import annotations

import statistics

import numpy as np
import pytest

from bench.harness import roofline, stats, trace


def test_percentile_over_all_samples_matches_numpy():
    rng = np.random.default_rng(0)
    xs = rng.exponential(size=333).tolist()
    for q in (0, 50, 95, 99, 100):
        assert stats.percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)), rel=1e-12)
    assert stats.percentile([], 95) is None
    assert stats.percentile([4.0], 95) == 4.0


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


def test_union_merges_overlaps_and_drops_empty():
    got = stats.union([(5, 7), (0, 2), (1, 3), (6, 9), (10, 10)])
    assert got == [(0, 3), (5, 9)]


def test_idle_share_counts_overlapping_kernels_once_and_copies():
    # window 0..100 us; kernels 10..30 and 20..40 overlap; a copy 60..70;
    # a kernel past the window's end is clipped
    events = [("bench.run", False, 0.0, 45.0),
              ("bench.step", False, 45.0, 100.0),
              ("kernel_a(int)", True, 10.0, 30.0),
              ("kernel_a(int)", True, 20.0, 40.0),
              ("Memcpy DtoH", True, 60.0, 70.0),
              ("kernel_b", True, 95.0, 130.0)]
    s = trace.summarize(events, (0.0, 100.0), (1.0, 2.0))
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(45e-6)        # 10..40, 60..70, 95..100
    assert s.idle_percent == pytest.approx(55.0)
    ops = dict(s.device_ops)
    assert ops["kernel_a"] == pytest.approx(40e-6)  # by name, overlaps summed
    assert ops["Memcpy DtoH"] == pytest.approx(10e-6)
    gaps = dict(s.idle_gaps)
    # a gap goes whole to the span at its middle
    assert gaps["run"] == pytest.approx(10e-6)      # 0..10
    assert gaps["step"] == pytest.approx(45e-6)     # 40..60, 70..95


def test_gap_outside_every_span_is_the_harness():
    s = trace.summarize([("k", True, 0.0, 1.0)], (0.0, 3.0), (0.0, 0.0))
    assert s.idle_gaps == [["harness", pytest.approx(2e-6)]]


def test_no_device_time_reads_nothing():
    s = trace.summarize([("bench.run", False, 0.0, 5.0)], (0.0, 5.0),
                        (0.0, 0.0))
    assert s.busy_s == 0 and s.idle_percent is None


def test_bfs_bytes_count_edges_of_the_component_and_every_vertex():
    # a component of 3 tuples: 6 directed edges of 4 bytes, 10 vertices
    # of 8 bytes (offset read, level written)
    assert roofline.bfs_search_bytes(3, 10) == 6 * 4 + 10 * 8
    # scale 21's giant component: about 2% of a 4 ms search at 3.35 TB/s
    b = roofline.bfs_search_bytes(33_500_000, 1 << 21)
    assert 0.01 < b / 3.35e12 / 4e-3 < 0.03
