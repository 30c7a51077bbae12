"""What the benchmark runs, found by name: ``BENCHMARK.json`` at the root of
the checkout, each configuration's file (``file``), each traffic mix's file
under ``traffic/`` and each per-layer metric's reader under ``metrics/``.
A cell, configuration, traffic mix or metric is added by adding its files
and its entries; nothing here names one.
"""

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# top-level module names that no run may hold: JAX and the JAX package (the
# port's name begins with the latter's, so names are compared whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "adaptigraph_tpu")


def load_spec(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def traffic_path(name, bench_dir=BENCH_DIR):
    """The traffic mix's data file: ``traffic/<name>.json``."""
    return os.path.join(bench_dir, "traffic", name + ".json")


def metric_path(name, bench_dir=BENCH_DIR):
    return os.path.join(bench_dir, "metrics", name + ".py")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def resolve_cell(spec, workload, root=ROOT, bench_dir=BENCH_DIR):
    """The cell's entry, its configuration (the file's contents), its traffic
    mix (the file's contents) and the names of its end-to-end and per-layer
    metrics."""
    cell = by_name(spec["workloads"], workload, "workload")
    cfg_entry = by_name(spec["configs"], cell["config"], "config")
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(traffic_path(cell["traffic"], bench_dir))

    def applies(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    end_to_end = [m for m in spec["end_to_end"] if applies(m)]
    names = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"] if applies(m) and m["moves"] in names]
    return cell, config, traffic, end_to_end, per_layer


def load_reader(name, bench_dir=BENCH_DIR):
    """A per-layer metric's reader: ``metrics/<name>.py``'s ``read(run)``,
    which returns the value or None where it finds nothing to read."""
    path = metric_path(name, bench_dir)
    mod_name = "bench_metric_" + re.sub(r"\W", "_", name)
    module_spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read


def forbidden_modules(modules):
    """The names in ``modules`` (e.g. ``sys.modules``) whose top-level name,
    the part before the first dot, is one of ``FORBIDDEN_MODULES``."""
    return sorted(n for n in modules if n.split(".", 1)[0] in FORBIDDEN_MODULES)


def check_names(spec):
    """Every name and unit of ``spec`` keeps to the allowed characters.
    Returns the list of faults (empty when sound)."""
    faults = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[key]:
            if not NAME.match(e["name"]):
                faults.append(f"{key}: name {e['name']!r}")
            if "unit" in e and not UNIT.match(e["unit"]):
                faults.append(f"{key}: unit {e['unit']!r}")
    for c in spec["configs"]:
        faults += [f"configs: reduced key {k!r}" for k in c["reduced"] if not NAME.match(k)]
    for w in spec["workloads"]:
        for k in ("config", "traffic"):
            if not NAME.match(w[k]):
                faults.append(f"workloads: {k} {w[k]!r}")
    return faults
