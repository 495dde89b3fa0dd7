"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3; NVIDIA's data
sheet, dense rates, at the full 700 W power limit).

A product of fp32 operands runs no faster than the tensor cores' TF32
rate, so the roofline of fp32 work is taken at TF32's peak, and of bf16
work at bf16's."""
from __future__ import annotations

H100_SXM = {
    "bfloat16_flops": 989.4e12,
    "tf32_flops": 494.7e12,
    "float32_cuda_core_flops": 66.9e12,
    "hbm_bytes_per_s": 3.35e12,
}


def matmul_peak(dtype: str) -> float:
    """FLOP/s of the peak that work in ``dtype`` is held to."""
    if dtype == "float32":
        return H100_SXM["tf32_flops"]
    if dtype in ("bfloat16", "float16"):
        return H100_SXM["bfloat16_flops"]
    raise ValueError(f"no peak for dtype {dtype!r}")


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: max(operations / peak, bytes /
    HBM bandwidth)."""
    return max(flops / matmul_peak(dtype),
               nbytes / H100_SXM["hbm_bytes_per_s"])
