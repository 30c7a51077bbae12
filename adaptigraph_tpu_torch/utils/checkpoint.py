"""Read checkpoints written by ``adaptigraph_tpu/utils/checkpoint.py``.

A JAX checkpoint is an npz of ``leaf_0 .. leaf_{n-1}`` in the order JAX
flattens the parameter dict (sorted keys; each layer is ``{b, w}``) plus
``__treedef__``, a pickled JAX treedef. Unpickling that needs JAX, so it is
ignored here: the fixed leaf order below rebuilds the same nested dict of
numpy arrays. Writing checkpoints comes with the training slice.
"""

import os

import numpy as np

# JAX flatten order of the GNN parameter dict (sorted keys, b before w).
_MLP3 = [(i, k) for i in range(3) for k in ("b", "w")]
LEAF_ORDER = (
    [("non_rigid_predictor", i, k) for i, k in _MLP3]
    + [("particle_encoder", i, k) for i, k in _MLP3]
    + [("particle_propagator", None, k) for k in ("b", "w")]
    + [("relation_encoder", i, k) for i, k in _MLP3]
    + [("relation_propagator", None, k) for k in ("b", "w")]
)


def checkpoint_name(out_dir, epoch):
    return os.path.join(out_dir, "checkpoints", f"model_{epoch}.npz")


def latest_name(out_dir):
    return os.path.join(out_dir, "checkpoints", "latest.npz")


def param_shapes(cfg):
    """Expected shape of every leaf of ``LEAF_ORDER`` for a ``GNNConfig``."""
    nf = cfg.nf_effect

    def mlp(n_in, n_hidden, n_out):
        return [(n_hidden,), (n_in, n_hidden), (n_hidden,), (n_hidden, n_hidden),
                (n_out,), (n_hidden, n_out)]

    return (mlp(nf, nf, 3)
            + mlp(cfg.particle_input_dim, cfg.nf_particle, nf)
            + [(nf,), (2 * nf, nf)]
            + mlp(cfg.relation_input_dim, cfg.nf_relation, nf)
            + [(nf,), (3 * nf, nf)])


def load_checkpoint(out_dir, epoch=None, cfg=None):
    """Load ``checkpoints/latest.npz`` (or ``model_{epoch}.npz``) as the
    nested parameter dict of numpy arrays that JAX ``load_pytree`` returns.
    With ``cfg`` (a ``GNNConfig``), every leaf shape is checked against it."""
    path = latest_name(out_dir) if epoch is None else checkpoint_name(out_dir, epoch)
    with np.load(path, allow_pickle=False) as z:
        names = [f for f in z.files if f.startswith("leaf_")]
        if len(names) != len(LEAF_ORDER):
            raise ValueError(f"{path}: {len(names)} leaves, expected {len(LEAF_ORDER)}")
        leaves = [np.asarray(z[f"leaf_{i}"]) for i in range(len(LEAF_ORDER))]
    if cfg is not None:
        for (mod, i, k), leaf, shape in zip(LEAF_ORDER, leaves, param_shapes(cfg)):
            if leaf.shape != shape:
                where = f"{mod}[{i}].{k}" if i is not None else f"{mod}.{k}"
                raise ValueError(f"{path}: {where} has shape {leaf.shape}, "
                                 f"the config needs {shape}")
    tree = {}
    for (mod, i, k), leaf in zip(LEAF_ORDER, leaves):
        if i is None:
            tree.setdefault(mod, {})[k] = leaf
        else:
            tree.setdefault(mod, [{}, {}, {}])[i][k] = leaf
    return tree
