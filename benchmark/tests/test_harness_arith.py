"""The copied operation, byte and bound arithmetic, pinned to the bounds
PERF.md's kernel table gives at N = 131,072, G = 1000, R = 2, S = 10."""

import pytest

from benchmark import roofline

N, G, R, S = 131072, 1000, 2, 10


def test_k1_headline_bound():
    ms, by = roofline.bound(roofline.sweep_flops(N, 10, S), roofline.sweep_bytes(N, G, 10, R, S))
    assert by == "operations"
    assert round(ms, 4) == 0.1295


def test_k3_bound_at_k50():
    ms, by = roofline.bound(roofline.sweep_flops(N, 50, S), roofline.sweep_bytes(N, G, 50, R, S))
    assert by == "operations"
    assert round(ms, 4) == 14.9676


def test_k2_one_rating_bound():
    ms, by = roofline.bound(roofline.score_flops(N, 10, S), roofline.score_bytes(N, G, 10, S))
    assert by == "operations"
    assert round(ms, 4) == 0.0434


@pytest.mark.parametrize("k", [10, 50])
def test_sweep_counts_scale_with_rows_and_restarts(k):
    one = roofline.sweep_flops(1, k, 1)
    assert roofline.sweep_flops(104858, k, 10) == pytest.approx(104858 * 10 * one)
    assert one == 2 * (3 * k**3 + 3 * k**2 + k)
