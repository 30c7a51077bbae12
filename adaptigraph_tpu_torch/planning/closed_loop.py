"""Planning task settings and the MPPI reward (counterpart of the first part
of ``adaptigraph_tpu/planning/closed_loop.py``).

The closed loop itself (``run_plan``, ``run_random_interact``) needs the
simulator-backed environment and perception, which come with a later slice.
"""

import dataclasses

import numpy as np
import torch

from adaptigraph_tpu_torch.ops.costs import (bbox_penalty, box_loss, chamfer, cloth_penalty,
                                             granular_penalty, rope_penalty)
from adaptigraph_tpu_torch.planning.forward import DynamicsConfig
from adaptigraph_tpu_torch.planning.mppi_solve import MPPIConfig

PENALTIES = {"rope": rope_penalty, "cloth": cloth_penalty,
             "granular": granular_penalty, "none": None}


@dataclasses.dataclass
class TaskConfig:
    """The planning-task fields that the solver and the reward read."""

    dcfg: DynamicsConfig
    mcfg: MPPIConfig
    action_lower_lim: np.ndarray
    action_upper_lim: np.ndarray
    n_actions: int = 10
    penalty_type: str = "rope"
    target_type: str = "pcd"  # or "box"
    fps_radius: float = 0.2
    sim_real_ratio: float = 10.0
    workspace_bbox: np.ndarray = None  # (2, 2) sim-frame [x, z] bounds
    ppo_iterations: int = 50
    target_path: str = None


def make_reward_fn(task: TaskConfig, target, device="cuda"):
    """reward = -normalised final error - 5 * mean collision penalty
    - 5 * mean workspace penalty. The error is normalised by 2/max within
    each scored batch (one MPPI chunk)."""
    penalty = PENALTIES[task.penalty_type]
    bbox = (torch.as_tensor(task.workspace_bbox, dtype=torch.float32, device=device)
            if task.workspace_bbox is not None else None)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)

    def reward_fn(state_seqs, act_seqs, state_cur):
        B = state_seqs.shape[0]
        final = state_seqs[:, -1]
        if task.target_type == "box":
            error = box_loss(final, target)
        else:
            error = chamfer(final, target[None].expand(B, *target.shape))
        error_weight = 2.0 / (error.max() + 1e-6)
        r = -error_weight * error
        if penalty is not None:
            r = r - 5.0 * penalty(state_seqs, act_seqs, state_cur).mean(dim=1)
        if bbox is not None:
            r = r - 5.0 * bbox_penalty(state_seqs, bbox).mean(dim=1)
        return r

    return reward_fn
