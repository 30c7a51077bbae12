"""The whole train step's share of the card's float32 peak (split TF32), in
%: the model FLOPs of the window's steps (forward and backward of every
prediction, ``work/gnn_step.py`` on the reference's edges) over the window
and the peak."""


def read(run):
    layer = run.layer
    if "step_model_flops" not in layer:
        return None
    flops = layer["step_model_flops"] * layer["steps"]
    return 100.0 * flops / (layer["window_s"] * layer["train_peak_flops"])
