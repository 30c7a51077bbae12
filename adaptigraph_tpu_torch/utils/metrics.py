"""Structured metrics logging (copy of ``adaptigraph_tpu/utils/metrics.py``):
an append-only JSONL writer, one event per line, with optional TensorBoard
mirroring when ``torch.utils.tensorboard`` imports."""

import json
import os
import time


class MetricsLogger:
    """Append-only JSONL metrics with optional TensorBoard mirroring.

    >>> m = MetricsLogger(out_dir)
    >>> m.log("train", step=10, loss=0.5)
    """

    def __init__(self, out_dir, filename="metrics.jsonl", tensorboard=False):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, filename)
        self._f = open(self.path, "a", buffering=1)
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(out_dir, "tb"))
            except ImportError:
                pass

    def log(self, tag, step=None, **scalars):
        rec = {"ts": time.time(), "tag": tag, "step": step, **scalars}
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                try:
                    self._tb.add_scalar(f"{tag}/{k}", float(v), step or 0)
                except (TypeError, ValueError):
                    pass

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def read_metrics(path):
    """Load a metrics.jsonl back into a list of dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
