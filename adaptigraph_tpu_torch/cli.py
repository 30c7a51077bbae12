"""Command-line entry point of the PyTorch port (counterpart of
``adaptigraph_tpu/cli.py``)::

    python -m adaptigraph_tpu_torch demo-ppo --config rope \\
        --load_dir fixtures/rope_demo --ckpt_dir fixtures/rope_demo

Commands run on the CUDA card unless ``--device cpu`` is given.
"""

import argparse
import dataclasses

import numpy as np
import torch


# ---------------------------------------------------------------------------
# config -> framework objects
# ---------------------------------------------------------------------------

def edge_policy(dataset_cfg):
    """The tool-connection policy a dataset config selects."""
    ds = dataset_cfg
    if ds.get("connect_tool_all_non_fixed"):
        return "non_fixed"
    if ds.get("connect_tool_all"):
        return "tools_all"
    if ds.get("connect_tools_surface") or ds.get("connect_tool_surface"):
        return "surface"
    return "none"


def _dyn_objects(config):
    """dynamics config dict -> (gnn_cfg, edge_cfg)."""
    from adaptigraph_tpu_torch.models.gnn import model_config_from_yaml
    from adaptigraph_tpu_torch.ops.graph import EdgeConfig

    gnn_cfg = model_config_from_yaml(config)
    ds = config["dataset_config"]["datasets"][0]
    edge_cfg = EdgeConfig(
        max_nobj=ds["max_nobj"], max_neef=config["dataset_config"]["eef"]["max_neef"],
        topk=ds["topk"], policy=edge_policy(ds),
        surface_ratio=float(ds.get("connect_tool_surface_ratio", 1.0)),
    )
    return gnn_cfg, edge_cfg


def _task_objects(task):
    """planning task config -> (TaskConfig, dynamics config dict)."""
    from adaptigraph_tpu_torch.planning.closed_loop import TaskConfig
    from adaptigraph_tpu_torch.planning.forward import DynamicsConfig
    from adaptigraph_tpu_torch.planning.mppi_solve import MPPIConfig

    config = task["_dynamics_config"]
    gnn_cfg, edge_cfg = _dyn_objects(config)
    if edge_cfg.policy == "tools_all":
        # planning gates the tool connections per sample on contact
        edge_cfg = dataclasses.replace(edge_cfg, gate_on_contact=True)
    dcfg = DynamicsConfig(
        gnn=gnn_cfg, edge=edge_cfg, n_his=task.get("n_his", gnn_cfg.n_his),
        push_length=task.get("push_length", 0.1),
        sim_real_ratio=task.get("sim_real_ratio", 10.0),
        max_repeat=int(np.ceil(task["action_upper_lim"][3])),
        pusher_offsets=tuple(task.get("pusher_points", [])) or (),
        gripper_enable=task.get("gripper_enable", False),
        adj_thresh=task.get("adj_thresh", 0.5),
    )
    mcfg = MPPIConfig(
        n_sample=task.get("n_sample", 20000),
        n_sample_chunk=task.get("n_sample_chunk", 2000),
        n_look_ahead=task.get("n_look_ahead", 1),
        n_update_iter=task.get("n_update_iter", 1),
        reward_weight=task.get("reward_weight", 500.0),
        noise_level=task.get("noise_level", 1.0),
        push_length=task.get("push_length", 0.1),
    )
    ratio = task.get("sim_real_ratio", 10.0)
    tcfg = TaskConfig(
        dcfg=dcfg, mcfg=mcfg,
        action_lower_lim=np.asarray(task["action_lower_lim"], np.float32),
        action_upper_lim=np.asarray(task["action_upper_lim"], np.float32),
        n_actions=task.get("n_actions", 10),
        penalty_type=task.get("penalty_type", "none"),
        target_type=task.get("target_type", "pcd"),
        fps_radius=task.get("fps_radius", 0.2),
        sim_real_ratio=ratio,
        target_path=task.get("target", None),
        # board-frame [x_min, x_max, z_min, z_max, ...] -> sim-frame (2, 2)
        workspace_bbox=(np.asarray(task["bbox"][:4], np.float32).reshape(2, 2) * ratio
                        if task.get("bbox") is not None else None),
    )
    return tcfg, config


def load_params(ckpt_dir, gnn_cfg, device, epoch=None):
    """Checkpoint in ``ckpt_dir`` -> the nested parameter dict on ``device``."""
    from adaptigraph_tpu_torch.models.gnn import params_from_numpy
    from adaptigraph_tpu_torch.utils.checkpoint import load_checkpoint

    return params_from_numpy(load_checkpoint(ckpt_dir, epoch=epoch, cfg=gnn_cfg), device)


def resolve_device(name):
    """The device a command runs on; 'cuda' without a card is an error."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available (use --device cpu to run the plain "
                         "PyTorch versions on the CPU)")
    return device


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def cmd_demo_ppo(args):
    """Replay recorded interaction fixtures through the physics-parameter
    optimizer and print the estimate."""
    from adaptigraph_tpu_torch.planning.physics_optimizer import PhysicsParamOnlineOptimizer
    from adaptigraph_tpu_torch.utils.config import load_planning_config

    device = resolve_device(args.device)
    task = load_planning_config(args.config)
    tcfg, _ = _task_objects(task)
    if not args.ckpt_dir:
        raise SystemExit("demo-ppo needs --ckpt_dir")
    params = load_params(args.ckpt_dir, tcfg.dcfg.gnn, device, args.epoch)
    # the device picks the path, as the JAX package's backend does: bfloat16
    # through the kernel on the card, float32 through the plain version on the CPU
    cd = torch.bfloat16 if device.type == "cuda" else torch.float32
    ppo = PhysicsParamOnlineOptimizer(tcfg.dcfg, params, phys_dim=tcfg.dcfg.gnn.phys_dim,
                                      device=device, compute_dtype=cd)
    ppo.load_interactions(args.load_dir)
    est, err, err0 = ppo.optimize(iterations=args.iterations)
    print(f"physics estimate: {est} (error {err:.5f} <- init {err0:.5f})")
    return est, err, err0


def build_parser():
    p = argparse.ArgumentParser(prog="adaptigraph_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    dp = sub.add_parser("demo-ppo", help="physics-param demo on recorded fixtures")
    dp.add_argument("--config", required=True)
    dp.add_argument("--load_dir", required=True)
    dp.add_argument("--ckpt_dir")
    dp.add_argument("--epoch", type=int)
    dp.add_argument("--iterations", type=int, default=50)
    dp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dp.set_defaults(fn=cmd_demo_ppo)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
