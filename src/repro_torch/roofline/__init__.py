"""Roofline accounting: a step's flops, bytes and peak memory counted on
``meta`` tensors, and the H100's peaks (``count``)."""
from .count import (  # noqa: F401
    HBM_BYTES,
    HBM_BYTES_PER_S,
    NVLINK_BYTES_PER_S,
    PEAK_BF16_FLOPS,
    PEAK_RTOL,
    StepCounter,
    analyze_step,
    depth_axes,
    depth_weighted,
)
