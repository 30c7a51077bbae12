"""The JAX package's ``ops`` exports (its ``fps_jax`` is ``fps_device``
here), imported at first access: ``ops.padding`` is part of the I/O tier,
whose spawned processes start without torch."""

from adaptigraph_tpu_torch._lazy import lazy_exports

__getattr__, __dir__ = lazy_exports(__name__, {
    **dict.fromkeys(("box_loss", "chamfer", "cloth_penalty", "granular_penalty",
                     "masked_chamfer", "rope_penalty"), "costs"),
    **dict.fromkeys(("fps_device", "fps_downsample", "fps_numpy", "fps_rad_numpy"), "fps"),
    **dict.fromkeys(("EdgeConfig", "build_neighbor_graph", "graph_to_edge_set",
                     "neighbor_aggregate", "neighbor_gather"), "graph"),
})
