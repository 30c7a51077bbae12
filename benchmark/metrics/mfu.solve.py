"""The whole solve's share of the cards' bf16 peak, in %: K1's launches in
the window (the port's counter) times the model FLOPs a launch (``work/k1.py``
on the reference's counts), over the window and the peak of every card."""

from work import peaks


def read(run):
    layer = run.layer
    if "k1_ops_per_launch" not in layer or not layer.get("k1_window_launches"):
        return None
    flops = layer["k1_window_launches"] * layer["k1_ops_per_launch"]
    return 100.0 * flops / (layer["window_s"] * peaks.BF16_FLOPS * layer["n_cards"])
