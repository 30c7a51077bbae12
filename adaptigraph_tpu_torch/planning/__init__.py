"""See the package docstring of adaptigraph_tpu_torch."""

from adaptigraph_tpu_torch.planning.actions import (
    angle_normalize,
    clip_actions,
    decode_action,
    optimize_action_mppi,
    sample_action_seq,
    sample_action_seq_correlated,
)
from adaptigraph_tpu_torch.planning.forward import (DynamicsConfig, dynamics_masked,
                                                    dynamics_rollout)
from adaptigraph_tpu_torch.planning.planner import Planner, PlannerConfig
