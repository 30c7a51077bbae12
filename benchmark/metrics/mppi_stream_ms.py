"""The solve's stream time outside K1 and the reward, in ms a solve: the
spans of the weights' and inputs' copies, the sampling, the sort by repeat,
each launch's K1 inputs, the softmax update and the best row
(``planning/mppi_solve.py``, ``planning/forward.py``, ``ops/fused_gnn.py``)
in the traced window."""

from metrics._spans import ms_per_unit

NAMES = {"mppi.weights", "mppi.inputs", "mppi.sample", "mppi.sort", "k1.inputs", "mppi.update",
         "mppi.best"}


def read(run):
    return ms_per_unit(run, NAMES, stream=True)
