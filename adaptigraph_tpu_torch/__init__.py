"""AdaptiGraph in PyTorch for one NVIDIA H100.

The PyTorch counterpart of ``adaptigraph_tpu``: module names mirror the JAX
package so each function's reference is found at the same path there. This
package imports ``torch`` and never ``jax`` or ``adaptigraph_tpu``.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU. On CUDA tensors the hand-written kernels in ``csrc/`` run; on CPU
tensors their plain PyTorch versions run.
"""

__version__ = "0.1.0"
