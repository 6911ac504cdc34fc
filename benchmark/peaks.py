"""The card's peaks: NVIDIA's data sheet for the H100 SXM (dense rates,
at its full power limit of 700 W). A roofline share is stated against
these, with the card's power limit printed beside it."""

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_FP32_PER_S = 67e12     # float32 outside the tensor cores


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time for moving n_bytes and doing n_ops fp32 operations."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FP32_PER_S)
