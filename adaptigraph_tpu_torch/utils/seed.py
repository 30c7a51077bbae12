"""Seeding helpers (counterpart of ``adaptigraph_tpu/utils/seed.py``).

``set_seed`` pins the host's numpy and python generators, as the JAX
package's does, and also seeds ``torch``'s default generators (the CPU's and
every card's), which the JAX package has no counterpart of: its device-side
randomness is explicit keys.
"""

import random

import numpy as np
import torch


def set_seed(seed: int):
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def np_rng(seed=None):
    return np.random.default_rng(seed)
