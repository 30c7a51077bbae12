"""The JAX package's ``utils`` exports, imported at first access:
``utils.nested`` is part of the I/O tier, whose spawned processes start
without torch."""

from adaptigraph_tpu_torch._lazy import lazy_exports

__getattr__, __dir__ = lazy_exports(__name__, {"load_yaml": "config", "set_seed": "seed"})
