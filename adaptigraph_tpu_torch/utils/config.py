"""YAML config loading (counterpart of ``adaptigraph_tpu/utils/config.py``).

The port reads its own copies of the yaml files under
``adaptigraph_tpu_torch/configs/``, by material name or by path. A path to a
file of the JAX package, such as the ``adaptigraph_tpu/configs/dynamics/
<name>.yaml`` that the shipped planning configs name, is read from the port's
copy of ``<name>.yaml``, and a missing copy is an error; any other path is
read as given.
"""

import os

import yaml


def load_yaml(path):
    with open(path, "r") as f:
        return yaml.safe_load(f)


PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG_DIR = os.path.join(os.path.dirname(PKG_DIR), "adaptigraph_tpu")


def config_dir():
    return os.path.join(PKG_DIR, "configs")


def config_path(name_or_path, kind):
    """The yaml file the port reads for a ``kind`` ("dynamics", "planning"
    or "data_gen") config named by material or by path: for a path inside the
    JAX package (relative, under ``adaptigraph_tpu/``, or absolute), the
    port's copy of the same name, which must exist; for another existing
    path, the path; else ``configs/<kind>/<name>.yaml``."""
    rel = os.path.normpath(name_or_path)
    in_jax_pkg = (os.path.commonpath([rel, JAX_PKG_DIR]) == JAX_PKG_DIR if os.path.isabs(rel)
                  else rel.split(os.sep)[0] == "adaptigraph_tpu")
    if in_jax_pkg:
        own = os.path.join(config_dir(), kind, os.path.basename(rel))
        if not os.path.exists(own):
            raise FileNotFoundError(f"{name_or_path!r} is a config of the JAX package, of which "
                                    f"the port has no copy: expected {own}")
        return own
    if os.path.exists(name_or_path):
        return name_or_path
    return os.path.join(config_dir(), kind, f"{name_or_path}.yaml")


def load_dynamics_config(name_or_path, validate=True):
    """Load a dynamics config by material name (e.g. 'rope') or path."""
    cfg = load_yaml(config_path(name_or_path, "dynamics"))
    if validate:
        from adaptigraph_tpu_torch.utils.validate import validate_dynamics_config

        validate_dynamics_config(cfg)
    return cfg


def load_planning_config(name_or_path):
    """Load a planning task config by material name or path, with the
    dynamics config it names under ``task["_dynamics_config"]``."""
    task = load_yaml(config_path(name_or_path, "planning"))["task_config"]
    task["_dynamics_config"] = load_dynamics_config(task["config"])
    from adaptigraph_tpu_torch.utils.validate import validate_planning_config

    validate_planning_config(task)
    return task
