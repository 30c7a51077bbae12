"""The solve's host time, in ms a solve: the ``mppi.solve`` spans (the
whole ``make_mppi_solver`` solve, from its call until every launch is
queued) in the traced window. Near ``solve_ms``, the host sets the pace."""

from metrics._spans import ms_per_unit


def read(run):
    return ms_per_unit(run, {"mppi.solve"}, stream=False)
