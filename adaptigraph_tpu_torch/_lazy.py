"""Package exports imported at first access, so that a light submodule (the
I/O tier's, which spawned processes import) does not pull in torch through
its package's ``__init__``."""

import importlib


def lazy_exports(package, names):
    """``__getattr__`` and ``__dir__`` for ``package`` that import
    ``names[attr]`` (a submodule name) on first access of ``attr``."""
    pkg = importlib.import_module(package)

    def __getattr__(attr):
        if attr not in names:
            raise AttributeError(f"module {package!r} has no attribute {attr!r}")
        value = getattr(importlib.import_module(f"{package}.{names[attr]}"), attr)
        setattr(pkg, attr, value)
        return value

    def __dir__():
        return sorted(set(vars(pkg)) | set(names))

    return __getattr__, __dir__
