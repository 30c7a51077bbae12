"""The weights a cell runs: a committed checkpoint read by the benchmark
itself, or seeded on the card. Both sides (the program and the reference)
get the same nested parameter dict of float32 tensors."""

import os

import numpy as np
import torch

from reference.gnn import LEAF_ORDER, leaf_shapes, tree_from_leaves


def read_checkpoint(path, m, device):
    """The ``leaf_<i>`` arrays of a checkpoint file (``np.savez``: the
    leaves in ``LEAF_ORDER``), checked against the model sizes ``m``."""
    with np.load(path, allow_pickle=False) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(LEAF_ORDER))]
    for (mod, i, k), leaf, shape in zip(LEAF_ORDER, leaves, leaf_shapes(m)):
        if tuple(leaf.shape) != tuple(shape):
            raise ValueError(f"{path}: {mod}.{i}.{k} has shape {leaf.shape}, the configuration "
                             f"{shape}")
    return tree_from_leaves([torch.tensor(a, dtype=torch.float32, device=device)
                             for a in leaves])


def seeded(seed, m, device):
    """Weights drawn on ``device`` from ``seed`` in one call: every layer's
    weight and bias uniform in +-1/sqrt(fan-in), as torch's ``nn.Linear``
    (and the port's ``init_params``) draw them."""
    shapes = leaf_shapes(m)
    # a bias takes its layer's weight's fan-in
    fan_in = [shapes[LEAF_ORDER.index((mod, i, "w"))][0] for mod, i, _ in LEAF_ORDER]
    sizes = [int(np.prod(s)) for s in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    bounds = torch.cat([torch.full((n,), 1.0 / float(np.sqrt(f)), device=device)
                        for n, f in zip(sizes, fan_in)])
    flat = u * bounds
    return tree_from_leaves([t.reshape(s).clone() for t, s in zip(flat.split(sizes), shapes)])


def make(config, seed, m, device, root):
    """The configuration's weights: ``weights.checkpoint`` (a path from the
    root of the checkout) or ``weights.seeded``."""
    w = config["weights"]
    if "checkpoint" in w:
        return read_checkpoint(os.path.join(root, w["checkpoint"]), m, device)
    return seeded(seed, m, device)
