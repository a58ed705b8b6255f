"""The card's rates and the least time of one operator apply: the
yardstick that ``op_roofline`` reads against (a frozen copy of
``eigensolvers_tpu_torch/tools/yardstick.py``'s ``HBM_BPS``, ``PEAK_FLOPS``
and ``bound``'s rule).

NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit: HBM bytes/s
and the fastest unit's flop/s by type: f32 on the CUDA cores, f64 on the
FP64 tensor cores (67 TFLOP/s; its CUDA cores give 34), bf16 on the
tensor cores.
"""

HBM_BPS = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 67e12, "bf16": 989e12}
ITEMSIZE = {"f32": 4, "f64": 8}


def bound_s(read_bytes, write_bytes, flops, kind):
    """The least time in s of work that reads ``read_bytes`` and writes
    ``write_bytes`` once each and does ``flops`` operations of type
    ``kind``: the larger of the bytes over the HBM rate and the flops over
    the type's peak."""
    return max((read_bytes + write_bytes) / HBM_BPS,
               flops / PEAK_FLOPS[kind])
