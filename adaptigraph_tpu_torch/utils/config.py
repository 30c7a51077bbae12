"""YAML config loading (counterpart of ``adaptigraph_tpu/utils/config.py``).

The port reads its own copies of the yaml files under
``adaptigraph_tpu_torch/configs/``. A planning config names its dynamics
config by path; the port resolves that name by its basename inside its own
``configs/dynamics/`` first.
"""

import os

import yaml


def load_yaml(path):
    with open(path, "r") as f:
        return yaml.safe_load(f)


def config_dir():
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def load_dynamics_config(name_or_path, validate=True):
    """Load a dynamics config by material name (e.g. 'rope') or explicit path."""
    if os.path.exists(name_or_path):
        cfg = load_yaml(name_or_path)
    else:
        cfg = load_yaml(os.path.join(config_dir(), "dynamics", f"{name_or_path}.yaml"))
    if validate:
        from adaptigraph_tpu_torch.utils.validate import validate_dynamics_config

        validate_dynamics_config(cfg)
    return cfg


def load_planning_config(name_or_path):
    """Load a planning task config by material name or explicit path, with
    its dynamics config under ``task["_dynamics_config"]``."""
    if os.path.exists(name_or_path):
        task = load_yaml(name_or_path)["task_config"]
    else:
        task = load_yaml(os.path.join(config_dir(), "planning", f"{name_or_path}.yaml"))["task_config"]
    dyn_path = os.path.join(config_dir(), "dynamics", os.path.basename(task["config"]))
    if not os.path.exists(dyn_path):
        dyn_path = task["config"]
    task["_dynamics_config"] = load_dynamics_config(dyn_path)
    from adaptigraph_tpu_torch.utils.validate import validate_planning_config

    validate_planning_config(task)
    return task
