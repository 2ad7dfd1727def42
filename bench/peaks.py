"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, no sparsity), at its 700 W power limit: the yardstick of every
roofline and ``mfu`` metric. A card set below 700 W reaches less; each
run prints the card's ``power.limit`` beside its numbers."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12,
             "int8": 1979e12}
#: the peak ``mfu`` metrics are taken against: the bf16 dense rate
MFU_PEAK = OPS_PER_S["bfloat16"]


def bound_s(ops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take: the larger of the operations
    at the peak rate for ``dtype`` and the bytes at the memory rate."""
    return max(ops / OPS_PER_S[dtype], nbytes / HBM_BYTES_PER_S)
