"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity), the yardstick of every roofline and `mfu` share.

SFU: 16 special-function results per SM per clock (4 per SM sub-partition),
132 SMs, at the 1.98 GHz boost clock. The rates assume the 700 W limit.
"""

HBM_BYTES_S = 3.35e12
FP32_FLOPS_S = 67e12
SFU_OPS_S = 132 * 16 * 1.98e9


def least_seconds(nbytes: float, fp32: float, sfu: float) -> float:
    """The least time one H100 needs for the work: the largest of its
    bytes over HBM bandwidth, its FP32 operations over the FP32 peak and
    its special-function operations over the SFU peak."""
    return max(nbytes / HBM_BYTES_S, fp32 / FP32_FLOPS_S, sfu / SFU_OPS_S)
