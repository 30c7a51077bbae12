"""Config validation.

The reference loads YAML with no schema — typos in config keys fail deep
inside training with opaque errors (SURVEY.md §5 "No validation/schema").
This is a light structural validator: required sections/keys, types, and
range sanity for the fields every consumer reads. Unknown keys are allowed
(configs carry material-specific extras).
"""


class ConfigError(ValueError):
    pass


def _require(d, key, typ, path):
    if key not in d:
        raise ConfigError(f"missing config key: {path}.{key}")
    v = d[key]
    if typ is float:
        if not isinstance(v, (int, float)):
            raise ConfigError(f"{path}.{key} must be a number, got {type(v).__name__}")
    elif not isinstance(v, typ):
        raise ConfigError(f"{path}.{key} must be {typ.__name__}, got {type(v).__name__}")
    return v


def validate_dynamics_config(config):
    """Validate a dynamics config dict (dataset/train/model/material
    sections). Returns the config for chaining; raises ConfigError."""
    dc = _require(config, "dataset_config", dict, "")
    _require(dc, "n_his", int, "dataset_config")
    _require(dc, "n_future", int, "dataset_config")
    _require(dc, "dist_thresh", float, "dataset_config")
    _require(dc, "materials", list, "dataset_config")
    eef = _require(dc, "eef", dict, "dataset_config")
    _require(eef, "max_neef", int, "dataset_config.eef")
    _require(eef, "pos", list, "dataset_config.eef")
    datasets = _require(dc, "datasets", list, "dataset_config")
    if not datasets:
        raise ConfigError("dataset_config.datasets is empty")
    for i, ds in enumerate(datasets):
        p = f"dataset_config.datasets[{i}]"
        _require(ds, "max_nobj", int, p)
        _require(ds, "topk", int, p)
        fr = _require(ds, "fps_radius_range", list, p)
        ar = _require(ds, "adj_radius_range", list, p)
        if len(fr) != 2 or fr[0] > fr[1]:
            raise ConfigError(f"{p}.fps_radius_range must be [lo, hi]")
        if len(ar) != 2 or ar[0] > ar[1]:
            raise ConfigError(f"{p}.adj_radius_range must be [lo, hi]")

    mc = _require(config, "model_config", dict, "")
    for k in ("nf_particle", "nf_relation", "nf_effect", "pstep"):
        v = _require(mc, k, int, "model_config")
        if v <= 0:
            raise ConfigError(f"model_config.{k} must be positive")

    matc = _require(config, "material_config", dict, "")
    for mat in dc["materials"]:
        if mat not in matc:
            raise ConfigError(f"material_config missing entry for '{mat}'")
        pp = _require(matc[mat], "physics_params", list, f"material_config.{mat}")
        for j, spec in enumerate(pp):
            p = f"material_config.{mat}.physics_params[{j}]"
            _require(spec, "name", str, p)
            _require(spec, "use", bool, p)
            if spec["use"]:
                lo = _require(spec, "min", float, p)
                hi = _require(spec, "max", float, p)
                if lo >= hi:
                    raise ConfigError(f"{p}: min must be < max")
    return config


def validate_planning_config(task):
    """Validate a planning task_config dict."""
    for k, typ in (("action_lower_lim", list), ("action_upper_lim", list),
                   ("n_sample", int), ("n_look_ahead", int)):
        _require(task, k, typ, "task_config")
    lo, hi = task["action_lower_lim"], task["action_upper_lim"]
    if len(lo) != 4 or len(hi) != 4:
        raise ConfigError("action limits must have 4 entries (x, z, theta, length)")
    if any(a >= b for a, b in zip(lo, hi)):
        raise ConfigError("action_lower_lim must be < action_upper_lim elementwise")
    if task.get("n_sample_chunk") and task["n_sample"] % task["n_sample_chunk"]:
        raise ConfigError("n_sample must be divisible by n_sample_chunk")
    return task
