"""The port's timestamp accumulators and nested-dict helpers: the cases of
``tests/test_accumulate.py``, each output equal to the JAX package's on the
same inputs (both are numpy, so equal means equal)."""

import numpy as np
import pytest

from adaptigraph_tpu.realworld import accumulate as jax_acc
from adaptigraph_tpu.utils import nested as jax_nested
from adaptigraph_tpu_torch.realworld import accumulate as acc
from adaptigraph_tpu_torch.utils import nested


def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


def test_accumulate_idxs_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(30):
        dt = rng.uniform(0.02, 0.2)
        start = rng.uniform(-1, 1)
        ts = np.sort(start + rng.uniform(-0.3, 3.0, rng.randint(0, 40)))
        for next_idx in [0, 3, None]:
            for allow_neg in [False, True]:
                kw = dict(next_global_idx=next_idx, allow_negative=allow_neg)
                _same(acc.accumulate_timestamp_idxs(ts, start, dt, **kw),
                      jax_acc.accumulate_timestamp_idxs(ts, start, dt, **kw))


def test_accumulate_boundary_eps():
    got = acc.accumulate_timestamp_idxs([0.0, 0.1, 0.2], 0.0, 0.1)
    _same(got, jax_acc.accumulate_timestamp_idxs([0.0, 0.1, 0.2], 0.0, 0.1))
    local, glob, nxt = got
    assert glob == [0, 1, 2] and local == [0, 1, 2] and nxt == 3


@pytest.mark.parametrize("stream,target", [([0.0, 0.1], [0, 1, 2, 3]),
                                           ([0.0, 0.05, 0.31], [1, 2, 3, 4, 5])])
def test_align_to_global_idxs_matches_jax(stream, target):
    got = acc.align_to_global_idxs(stream, target, 0.0, 0.1)
    _same(got, jax_acc.align_to_global_idxs(stream, target, 0.0, 0.1))


def _obs_run(mod):
    a = mod.TimestampObsAccumulator(start_time=0.0, dt=0.1)
    a.put({"x": np.array([[0.0], [1.0]])}, np.array([0.0, 0.1]))
    a.put({"x": np.array([[3.0]])}, np.array([0.3]))
    return len(a), a.data, a.timestamps, a.actual_timestamps


def test_obs_accumulator_fills_drops():
    got = _obs_run(acc)
    _same(got, _obs_run(jax_acc))
    np.testing.assert_allclose(got[1]["x"][:, 0], [0.0, 1.0, 3.0, 3.0])


def _action_run(mod):
    a = mod.TimestampActionAccumulator(start_time=0.0, dt=0.1)
    a.put(np.array([[1.0], [2.0], [3.0]]), np.array([0.0, 0.1, 0.2]))
    a.put(np.array([[20.0], [30.0], [40.0]]), np.array([0.1, 0.2, 0.3]))
    return len(a), a.actions, a.timestamps, a.actual_timestamps


def test_action_accumulator_overwrites():
    got = _action_run(acc)
    _same(got, _action_run(jax_acc))
    np.testing.assert_allclose(got[1][:, 0], [1.0, 20.0, 30.0, 40.0])


def _growth_run(mod):
    a = mod.TimestampObsAccumulator(start_time=0.0, dt=0.01)
    rng = np.random.RandomState(1)
    t = 0.0
    for _ in range(10):
        n = rng.randint(1, 20)
        ts = t + np.cumsum(rng.uniform(0.005, 0.03, n))
        a.put({"a": rng.randn(n, 3).astype(np.float32), "b": rng.randn(n).astype(np.float64)}, ts)
        t = ts[-1]
    return len(a), a.data, a.timestamps, a.actual_timestamps


def test_obs_accumulator_growth_and_multi_key():
    got = _growth_run(acc)
    _same(got, _growth_run(jax_acc))
    assert got[1]["a"].shape == (got[0], 3)
    np.testing.assert_allclose(np.diff(got[2]), 0.01)


def test_nested_dict_utils_match_jax():
    x = {"a": {"b": 1, "c": 2}, "d": 3}
    double = lambda v: v * 2  # noqa: E731
    assert nested.nested_dict_map(double, x) == jax_nested.nested_dict_map(double, x)
    assert nested.nested_dict_map(double, x) == {"a": {"b": 2, "c": 4}, "d": 6}
    add = lambda p, q: p + q  # noqa: E731
    assert nested.nested_dict_reduce(add, x) == jax_nested.nested_dict_reduce(add, x) == 6
    for f in (lambda v: v > 0, lambda v: v > 1):
        assert nested.nested_dict_check(f, x) == jax_nested.nested_dict_check(f, x)
    assert nested.nested_dict_check(lambda v: v > 0, x)
    assert not nested.nested_dict_check(lambda v: v > 1, x)
