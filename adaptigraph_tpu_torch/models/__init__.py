"""See the package docstring of adaptigraph_tpu_torch."""

from adaptigraph_tpu_torch.models.gnn import (
    GNNConfig,
    count_params,
    forward,
    forward_batch,
    init_params,
    model_config_from_yaml,
)
