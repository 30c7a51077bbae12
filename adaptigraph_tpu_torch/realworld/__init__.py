"""Perception and the real-robot I/O tier (counterpart of
``adaptigraph_tpu/realworld``). The package exports the shared-memory ring
and queue and the timestamp accumulators, as the JAX package's does; import
the perception, environment, camera, calibration and robot modules by name.
"""

from adaptigraph_tpu_torch.realworld.accumulate import (
    TimestampActionAccumulator,
    TimestampObsAccumulator,
    accumulate_timestamp_idxs,
    align_to_global_idxs,
)
from adaptigraph_tpu_torch.realworld.shm import ShmQueue, ShmRingBuffer
