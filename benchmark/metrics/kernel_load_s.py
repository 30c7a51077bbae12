"""The kernel library's set-up, in s: the nvcc builds' seconds
(``ops/kernels.py``'s ``build.build_s``, 0 where the library was built
already) and its load's and declarations' (``library.load_s``), all of it
in set-up. None where the port counts no load."""


def read(run):
    from adaptigraph_tpu_torch.ops import kernels

    load_s = getattr(kernels.library, "load_s", None)
    if not load_s:
        return None
    return getattr(kernels.build, "build_s", 0.0) + load_s
