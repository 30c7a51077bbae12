"""Perception and the real-robot I/O tier (counterpart of
``adaptigraph_tpu/realworld``), with the JAX package's exports.

The shared-memory ring and queue and the timestamp accumulators are imported
here. Perception, the point-cloud functions, the cameras and ``SimRealEnv``
are imported at first access: perception loads torch, and the spawned camera
processes, which import this package, must start without it.
"""

from adaptigraph_tpu_torch._lazy import lazy_exports
from adaptigraph_tpu_torch.realworld.accumulate import (
    TimestampActionAccumulator,
    TimestampObsAccumulator,
    accumulate_timestamp_idxs,
    align_to_global_idxs,
)
from adaptigraph_tpu_torch.realworld.shm import ShmQueue, ShmRingBuffer

__getattr__, __dir__ = lazy_exports(__name__, {
    **dict.fromkeys(("depth_to_points", "fuse_views", "crop_bbox", "voxel_downsample",
                     "remove_statistical_outliers", "z_percentile_filter"), "pointcloud"),
    **dict.fromkeys(("PerceptionModule", "construct_graph", "get_state_cur"), "perception"),
    **dict.fromkeys(("VirtualCamera", "make_multiview_cameras"), "cameras"),
    "SimRealEnv": "env",
})
