"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity), at its
700 W limit: the yardstick of every roofline share and `mfu` here. Each run
prints the card's own name and power limit beside its numbers."""

PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "fp32": 67e12}
HBM_BYTES_S = 3.35e12


def bound_s(work: dict, dtype: str) -> float:
    """The least time of `work` ({"ops", "bytes"}): the larger of its
    operations at the dtype's peak and its bytes at HBM's bandwidth."""
    return max(work["ops"] / PEAK_OPS[dtype], work["bytes"] / HBM_BYTES_S)


def binds(work: dict, dtype: str) -> str:
    """"operations" or "bytes", whichever sets bound_s."""
    return ("operations" if work["ops"] / PEAK_OPS[dtype]
            >= work["bytes"] / HBM_BYTES_S else "bytes")
