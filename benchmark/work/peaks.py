"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): bfloat16 989 TFLOP/s on the tensor cores, float32 as split
TF32 (three TF32 products a float32 product: 495 / 3 TFLOP/s), and 3.35 TB/s
of HBM."""

BF16_FLOPS = 989e12
F32_SPLIT_TF32_FLOPS = 495e12 / 3
HBM_BYTES = 3.35e12


def bound_s(ops, nbytes, peak_flops):
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory rate; and which of the two."""
    t_ops, t_bytes = ops / peak_flops, nbytes / HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
