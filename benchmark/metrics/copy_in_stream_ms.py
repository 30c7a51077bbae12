"""The graph inputs' stream time, in ms a step: the ``train.copy_in`` spans
(``dynamics/train.py::_Replay``, each replayed slice's copy into the
graph's static buffers) in the traced window."""

from metrics._spans import ms_per_unit


def read(run):
    return ms_per_unit(run, {"train.copy_in"}, stream=True)
