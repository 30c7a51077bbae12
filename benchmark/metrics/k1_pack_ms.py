"""K1's weight packing, in stream ms a solve: the ``k1.pack`` spans
(``ops/fused_gnn.py::rollout_chunk_cuda``, around the weights' padding and
the tensor-core layers' packing, ``pack_tc_weights``, inside each launch's
``k1.launch``) in the traced window. None where the port records no such
span."""

from metrics._spans import ms_per_unit


def read(run):
    return ms_per_unit(run, {"k1.pack"}, stream=True)
