"""Operations and bytes of one kernel call, from the cell's shapes, and
the least time the card could take for them."""


def bound_seconds(ops: float, nbytes: float, peak: dict) -> float:
    """The larger of operations over the int8 peak and bytes over the
    memory rate."""
    return max(ops / peak["int8_ops_per_s"], nbytes / peak["bytes_per_s"])
