"""See the package docstring of adaptigraph_tpu_torch."""

from adaptigraph_tpu_torch.dynamics.dataset import BatchLoader, DynDataset
from adaptigraph_tpu_torch.dynamics.graphs import GraphSpec, assemble_sample, collate
