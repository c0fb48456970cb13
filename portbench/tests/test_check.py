"""The comparison's arithmetic on hand-made readings."""

import pytest

from portbench import check


def test_loss_gap_is_the_first_step():
    assert check.loss_gap([10.0, 11.0], [10.001, 11.4]) == pytest.approx(0.001)


def test_leaf_gap_uses_the_median_leaf_for_still_leaves():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    prog = {"a": 1.01, "b": 2.0, "c": 0.02}
    # c's own norm is all but zero: its gap is taken against the median (1.0)
    assert check.leaf_gap(prog, ref) == pytest.approx(0.02, rel=1e-6)


def test_moving_leaves_leaves_out_round_off():
    assert check.moving_leaves({"a": 1.0, "b": 2.0, "c": 1e-4}) == ["a", "b"]


def test_mismatches_count_leaves():
    a = {"x": [1.0, 2.0], "y": [3.0]}
    assert check.mismatches([a, dict(a)]) == 0
    assert check.mismatches([a, {"x": [1.0, 2.0000001], "y": [3.0]}]) == 1


def test_judge():
    assert check.judge({"a": 1.0, "b": 0}, {"a": 1.0, "b": 0})
    assert not check.judge({"a": 1.1, "b": 0}, {"a": 1.0, "b": 0})
    assert not check.judge({"a": float("nan"), "b": 0}, {"a": 1.0, "b": 0})
