"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): the yardstick of every roofline and MFU."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12      # outside the tensor cores


def least_seconds(nbytes: float, flops_by_peak) -> tuple:
    """(least time in s, "bytes" or "operations"): the larger of the bytes
    over the memory bandwidth and the sum of each kind of operation over its
    peak (``flops_by_peak`` is [(flops, peak), ...])."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(f / peak for f, peak in flops_by_peak)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
