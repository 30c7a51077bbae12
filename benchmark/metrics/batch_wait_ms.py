"""The trainer's wait for a batch, in ms a step: the ``train.batch_wait``
spans (``dynamics/train.py::DevicePrefetcher.__next__``'s wait on its
queue) in the traced window."""

from metrics._spans import ms_per_unit


def read(run):
    return ms_per_unit(run, {"train.batch_wait"}, stream=False)
