"""The train step's graph captures, in s: ``GraphedStep.capture_s``
(``dynamics/train.py``), the host seconds of every capture (its eager first
slice included), all of them in set-up. None where the port counts no
capture."""


def read(run):
    from adaptigraph_tpu_torch.dynamics import train

    if not getattr(train.GraphedStep, "captures", 0):
        return None
    return train.GraphedStep.capture_s
