"""See the package docstring of adaptigraph_tpu_torch."""

from adaptigraph_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
