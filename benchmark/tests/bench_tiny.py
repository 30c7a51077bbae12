"""Cells cut to a size a CPU test can run: the configurations' widths and
the traffic's counts made small, seeded weights, the program's plain
versions (its CPU path)."""

import copy
import json
import os
import time

import torch

from harness import runner
from harness import spec as specs


def tiny_cell(workload, width=16):
    spec = specs.load_spec()
    cell, config, traffic, _, _ = specs.resolve_cell(spec, workload)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    mc = config["dynamics"]["model_config"]
    for key in ("nf_particle", "nf_relation", "nf_effect"):
        mc[key] = width
    config["weights"] = {"seeded": "tiny"}
    config["dynamics"]["train_config"]["batch_size"] = 4
    if "planning" in config:
        config["planning"].update(n_sample=80, n_sample_chunk=20)
    if traffic["kind"] == "solve":
        traffic.update(pool=2, warmup_solves=1, trace_solves=1, check_first=2)
    else:
        traffic.update(batch=4, steps_per_call=2, pool=2, trace_calls=1, check_first=2)
        if "lattice" in traffic:
            traffic["lattice"] = [[4, 3, 4], [5, 4, 5]]
    return cell, config, traffic


def run_tiny(workload, seed=1, seconds=0.0, faults=(), limits=None, control=None):
    cell, config, traffic = tiny_cell(workload)
    run = runner.Run(cell, config, traffic, seed, seconds, False, specs.ROOT,
                     torch.device("cpu"), limits, time.perf_counter(), control=control)
    run.faults = list(faults)
    runner.execute(run)
    return run


def limits_of(workload):
    path = os.path.join(specs.BENCH_DIR, "checks", workload + ".json")
    with open(path) as f:
        return json.load(f)["numbers"]
