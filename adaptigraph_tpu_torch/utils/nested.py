"""Nested-dict helpers for observation and command payloads (a copy of
``adaptigraph_tpu/utils/nested.py``): map, reduce and check over the leaves
of nested observation dicts, as the camera and robot tier uses them."""

import functools


def nested_dict_map(f, x):
    """Apply ``f`` to every leaf of a nested dict."""
    if not isinstance(x, dict):
        return f(x)
    return {key: nested_dict_map(f, value) for key, value in x.items()}


def nested_dict_reduce(f, x):
    """Reduce all leaves of a nested dict with binary ``f``."""
    if not isinstance(x, dict):
        return x
    return functools.reduce(f, (nested_dict_reduce(f, v) for v in x.values()))


def nested_dict_check(f, x):
    """True iff ``f(leaf)`` holds for every leaf."""
    return bool(nested_dict_reduce(lambda a, b: a and b,
                                   nested_dict_map(lambda v: bool(f(v)), x)))
