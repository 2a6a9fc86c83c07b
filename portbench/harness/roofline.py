"""Published peaks of one H100 and the least time of a piece of work.

NVIDIA's data sheet for the H100 SXM, dense rates outside the tensor cores:
67 TFLOP/s in float32, 34 TFLOP/s in float64, 3.35 TB/s of HBM3, at the
700 W power limit. The least time of a kernel is the larger of its
operations over the peak rate and its bytes over the memory rate.
"""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def least_seconds(n_bytes, flops, dtype):
    """(seconds, "bytes" or "operations"): the least time and its bound."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def share(least_s, device_s):
    """A roofline share in percent, or None when there is no device time."""
    if not device_s > 0:
        return None
    return 100.0 * least_s / device_s
