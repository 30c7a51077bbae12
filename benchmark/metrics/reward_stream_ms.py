"""The reward's stream time, in ms a solve: the ``mppi.reward`` spans
(``planning/mppi_solve.py``, around ``closed_loop.make_reward_fn``'s
function on each chunk) in the traced window."""

from metrics._spans import ms_per_unit


def read(run):
    return ms_per_unit(run, {"mppi.reward"}, stream=True)
