"""The card's idle share of the traced window, in %: 1 - the union of its
kernel, copy and set intervals over the window (averaged over the cards)."""


def read(run):
    layer = run.layer
    return 100.0 * (1.0 - layer["trace"]["busy_s"] / layer["trace_window_s"])
