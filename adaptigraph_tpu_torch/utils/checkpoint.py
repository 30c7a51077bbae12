"""Parameter checkpoints in the format of ``adaptigraph_tpu/utils/checkpoint.py``.

A JAX checkpoint is an npz of ``leaf_0 .. leaf_{n-1}`` in the order JAX
flattens the parameter dict (sorted keys; each layer is ``{b, w}``) plus
``__treedef__``, a pickled JAX treedef. Unpickling that needs JAX, so reading
ignores it: the fixed leaf order below rebuilds the same nested dict of numpy
arrays. Writing stores the treedef's bytes as JAX pickled them (they depend
only on the nesting, which every material shares; ``utils/params_treedef.bin``
holds them), so JAX ``load_pytree`` reads the port's parameter files.

The optimizer state (``latest_optim.npz``: Adam's ``count``, ``mu_i`` and
``nu_i`` in ``LEAF_ORDER``) is the port's own format, read by ``--resume``.

``save_pytree``/``load_pytree`` take any nesting of dicts, lists and tuples.
The parameter nesting is written with JAX's treedef; any other nesting, whose
treedef only JAX can write, gets the port's own structure record
(``__structure__``, JSON), which JAX's ``load_pytree`` does not read.
"""

import json
import os

import numpy as np

TREEDEF_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "params_treedef.bin")

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


def optim_name(out_dir):
    return os.path.join(out_dir, "checkpoints", "latest_optim.npz")


def tree_leaves(tree):
    """The parameter dict's leaves in ``LEAF_ORDER``."""
    return [tree[mod][k] if i is None else tree[mod][i][k] for mod, i, k in LEAF_ORDER]


def tree_from_leaves(leaves):
    """Inverse of ``tree_leaves``."""
    tree = {}
    for (mod, i, k), leaf in zip(LEAF_ORDER, leaves):
        if i is None:
            tree.setdefault(mod, {})[k] = leaf
        else:
            tree.setdefault(mod, [{}, {}, {}])[i][k] = leaf
    return tree


def save_params(path, tree):
    """Write a parameter dict of numpy arrays as JAX ``save_pytree`` does."""
    treedef = np.fromfile(TREEDEF_PATH, dtype=np.uint8)
    leaves = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(tree_leaves(tree))}
    np.savez(path, __treedef__=treedef, **leaves)


def _is_params(tree):
    """Whether ``tree`` has the GNN parameter dict's nesting."""
    layer = {"b", "w"}
    mlp = ("non_rigid_predictor", "particle_encoder", "relation_encoder")
    return (isinstance(tree, dict) and set(tree) == set(mlp) | {"particle_propagator",
                                                                "relation_propagator"}
            and all(isinstance(tree[m], list) and len(tree[m]) == 3
                    and all(isinstance(l, dict) and set(l) == layer for l in tree[m])
                    for m in mlp)
            and all(isinstance(tree[m], dict) and set(tree[m]) == layer
                    for m in ("particle_propagator", "relation_propagator")))


def _flatten(tree, leaves):
    """Leaves in JAX's flatten order (dict keys sorted; None has no leaf) and
    the nesting as JSON-ready data."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        if not all(isinstance(k, str) for k in keys):
            raise TypeError("save_pytree: dict keys must be strings")
        return {"dict": [[k, _flatten(tree[k], leaves)] for k in keys]}
    if isinstance(tree, (list, tuple)):
        return {type(tree).__name__: [_flatten(x, leaves) for x in tree]}
    if tree is None:
        return {"none": None}
    leaves.append(np.asarray(tree.detach().cpu() if hasattr(tree, "detach") else tree))
    return {"leaf": None}


def _unflatten(spec, leaves):
    (kind, body), = spec.items()
    if kind == "dict":
        return {k: _unflatten(v, leaves) for k, v in body}
    if kind in ("list", "tuple"):
        out = [_unflatten(v, leaves) for v in body]
        return out if kind == "list" else tuple(out)
    return None if kind == "none" else next(leaves)


def save_pytree(path, tree):
    """Write a nesting of arrays (numpy or torch) as an npz of ``leaf_i``."""
    if _is_params(tree):
        save_params(path, tree)
        return
    leaves = []
    spec = json.dumps(_flatten(tree, leaves)).encode()
    np.savez(path, __structure__=np.frombuffer(spec, dtype=np.uint8),
             **{f"leaf_{i}": x for i, x in enumerate(leaves)})


def load_pytree(path):
    """Read what ``save_pytree`` (either package's) wrote, as numpy arrays. A
    JAX file of a nesting other than the parameters' needs JAX to read."""
    with np.load(path, allow_pickle=False) as z:
        leaves = [np.asarray(z[f"leaf_{i}"]) for i in range(len(z.files) - 1)]
        if "__structure__" in z.files:
            return _unflatten(json.loads(z["__structure__"].tobytes()), iter(leaves))
        treedef = z["__treedef__"].tobytes()
    if treedef != np.fromfile(TREEDEF_PATH, dtype=np.uint8).tobytes():
        raise ValueError(f"{path}: a JAX treedef other than the GNN parameters'; "
                         "only JAX can read it")
    return tree_from_leaves(leaves)


def save_checkpoint(out_dir, epoch, params, opt_state=None):
    """``latest.npz`` every epoch and ``model_{epoch+1}.npz`` at the JAX
    package's cadence (every 10 epochs below 100, then every 100); the
    optimizer state, a dict of ``count`` and the ``mu``/``nu`` leaf lists,
    to ``latest_optim.npz``. Arrays are numpy."""
    os.makedirs(os.path.join(out_dir, "checkpoints"), exist_ok=True)
    if ((epoch + 1) < 100 and (epoch + 1) % 10 == 0) or (epoch + 1) % 100 == 0:
        save_params(checkpoint_name(out_dir, epoch + 1), params)
    save_params(latest_name(out_dir), params)
    if opt_state is not None:
        arrays = {"count": np.asarray(opt_state["count"], np.int32)}
        for name in ("mu", "nu"):
            arrays.update({f"{name}_{i}": np.asarray(x) for i, x in enumerate(opt_state[name])})
        np.savez(optim_name(out_dir), **arrays)


def load_optimizer(out_dir):
    """The optimizer state ``save_checkpoint`` wrote, as numpy arrays."""
    with np.load(optim_name(out_dir), allow_pickle=False) as z:
        n = len(LEAF_ORDER)
        return {"count": int(z["count"]),
                "mu": [np.asarray(z[f"mu_{i}"]) for i in range(n)],
                "nu": [np.asarray(z[f"nu_{i}"]) for i in range(n)]}


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
    return tree_from_leaves(leaves)
