"""Faults planted in the program under a run, to see ``correct`` come out
false: each ``plant_<name>(run)`` patches the port through ``run.patch``
(undone by ``run.restore`` before the comparison)."""

import torch


def plant_unchanged(run):
    """A train step that returns its state unchanged: Adam does nothing."""
    from adaptigraph_tpu_torch.dynamics import train

    run.patch(train, "adam_step", lambda *args, **kwargs: None)


def plant_half_batch(run):
    """Half of the batch left out: the train step's loss is the mean over
    the first half of the rows; a solve's chunk rolls out its first half
    and leaves the other half at its start state."""
    from adaptigraph_tpu_torch.dynamics import train
    from adaptigraph_tpu_torch.ops import fused_gnn

    loss = train.multi_step_loss

    def half_loss(params, batch, *args, **kwargs):
        B = batch["state"].shape[0]
        return loss(params, {k: (v[:B // 2] if torch.is_tensor(v) and v.dim() and v.shape[0] == B
                                 else v) for k, v in batch.items()}, *args, **kwargs)

    rollout = fused_gnn.rollout_chunk

    def half_rollout(pin, sa, repeat, valid, weights, cfg, *args, **kwargs):
        h = pin.shape[0] // 2
        out = sa[:, :cfg.max_nobj, :3].clone()
        out[:h] = rollout(pin[:h].contiguous(), sa[:h].contiguous(), repeat[:h].contiguous(),
                          valid[:h].contiguous(), weights, cfg, *args, **kwargs)
        return out

    run.patch(train, "multi_step_loss", half_loss)
    run.patch(fused_gnn, "rollout_chunk", half_rollout)


def plant_answer(run):
    """An answer altered where it is produced: the solve's best action moved
    by 0.05 in x; the train step's loss reported 1% high."""
    from adaptigraph_tpu_torch.dynamics import train
    from adaptigraph_tpu_torch.planning import mppi_solve

    make = mppi_solve.make_mppi_solver

    def make_altered(*args, **kwargs):
        solve = make(*args, **kwargs)

        def altered(*a, **k):
            out = dict(solve(*a, **k))
            out["act_seq"] = out["act_seq"] + torch.tensor([0.05, 0.0, 0.0, 0.0],
                                                           device=out["act_seq"].device)
            return out

        return altered

    loss = train.multi_step_loss
    run.patch(mppi_solve, "make_mppi_solver", make_altered)
    run.patch(train, "multi_step_loss", lambda *a, **k: loss(*a, **k) * 1.01)


def plant_reward(run):
    """A wrong reward: the solve scores its samples against a target moved
    by 0.05 in x."""
    from adaptigraph_tpu_torch.planning import closed_loop

    chamfer = closed_loop.chamfer
    shift = torch.tensor([0.05, 0.0, 0.0])

    run.patch(closed_loop, "chamfer", lambda x, y, *a, **k: chamfer(x, y + shift.to(y.device),
                                                                    *a, **k))


FAULTS = {"unchanged": plant_unchanged, "half_batch": plant_half_batch, "answer": plant_answer,
          "reward": plant_reward}
