"""Readings that the limits of ``checks/<workload>.json`` are set from: the
compared numbers of sound runs of the program on many seeds, of the control
(the reference in the program's place, a precision below the configuration's:
float8 for the bfloat16 rollout and bfloat16 for the float32 reward of the
solve, TF32 for the float32 training) and of planted
faults (``harness/faults.py``), all in one process so that set-up is paid
once:

    python3 benchmark/limits.py --workload rope_nf128.solve --seconds 3 \\
        --seeds 11 12 13 --control-seeds 21 22 23 [--fault half_batch --fault-seeds 31]

One JSON line a run on standard output (and appended to ``--out``).
"""

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import runner  # noqa: E402
from harness import spec as specs  # noqa: E402

CONTROL = {"solve": "fp8", "train": "tf32"}


def reading(args, cell, config, traffic, seed, control=None, fault=None):
    import torch

    run = runner.Run(cell, config, traffic, seed, args.seconds, False, specs.ROOT,
                     torch.device("cuda", 0), None, time.perf_counter(), control=control)
    run.faults = [fault] if fault else []
    t0 = time.perf_counter()
    runner.execute(run)
    out = {"workload": cell["name"], "seed": seed, "mode": fault or control or "program",
           "checks": {k: v["value"] for k, v in run.checks.items()}, "e2e": run.e2e,
           "setup_s": run.setup_s, "attempted": run.attempted,
           "run_s": time.perf_counter() - t0, "leaves": run.layer.get("leaf_gaps"),
           "loss_gaps": run.layer.get("loss_gaps"), "call_loss_gaps": run.layer.get("call_loss_gaps"),
           "call_grad_gaps": run.layer.get("call_grad_gaps"),
           "call_update_gaps": run.layer.get("call_update_gaps"),
           "work": {k: run.layer[k] for k in ("edges_per_sample", "k1_ops_per_launch")
                    if k in run.layer}}
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", default=None)
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args()
    spec = specs.load_spec()
    cell, config, traffic, _, _ = specs.resolve_cell(spec, args.workload)
    runner.cache_dirs(specs.ROOT)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    plan = ([(s, None, None) for s in args.seeds]
            + [(s, CONTROL[traffic["kind"]], None) for s in args.control_seeds]
            + [(s, None, args.fault) for s in args.fault_seeds])
    for seed, control, fault in plan:
        line = json.dumps(reading(args, cell, config, traffic, seed, control, fault))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
