"""What the span readers share: the port's span records
(``adaptigraph_tpu_torch/utils/profiling.py::SPANS``). The port records a
span only while a ``torch.profiler`` session is active, and the traced
window (``harness/trace.py::traced``) is a run's only session, so the
records hold exactly that window. A checkout whose port records no spans
gives None."""


def records():
    """The port's ``SPANS``, or None where the port has none."""
    from adaptigraph_tpu_torch.utils import profiling

    return getattr(profiling, "SPANS", None)


def ms_per_unit(run, names, stream):
    """The summed time of the spans named ``names`` (at any depth: the last
    part of the nested name), in ms a unit of the traced window (a solve or
    a step): stream time with ``stream``, else host time. None where no
    such span was recorded."""
    spans = records()
    if spans is None:
        return None
    stats = spans.stream_stats() if stream else spans.stats()
    hits = [s["total_s"] for name, s in stats.items() if name.rsplit("/", 1)[-1] in names]
    if not hits:
        return None
    return sum(hits) * 1e3 / run.layer["trace_units"]
