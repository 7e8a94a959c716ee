"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit)."""

#: float32 outside the tensor cores, FLOP/s
F32_FLOPS = 67e12
#: HBM3, bytes/s
HBM_BYTES_PER_S = 3.35e12


def bound_seconds(flops: float, nbytes: float, cards: int = 1) -> float:
    """The least time ``cards`` cards could take for this work: the larger
    of its FLOPs over the FLOP rate and its bytes over the memory rate."""
    return max(flops / (F32_FLOPS * cards), nbytes / (HBM_BYTES_PER_S * cards))
