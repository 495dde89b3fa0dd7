"""The split-TF32 arithmetic of the port's fp32 kernel routes (B5 and
B5-bwd, B6 and B6-bwd), in plain PyTorch, shared by the CPU tests that
hold each route's numeric design against the JAX package."""
import torch


def tf32(x):
    """fp32 -> TF32 as ``cvt.rna.tf32.f32`` rounds: 10 explicit mantissa
    bits, to nearest with ties away from zero, by integer ops on the fp32
    bits (the low 13 bits cleared)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    mag = ((u & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    out = (u & 0x80000000) | mag
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(
        torch.int32).view(torch.float32)


def mm3(a, b, *, single=False):
    """``a @ b`` as the fp32 routes take it on the tensor cores: each
    operand split as hi = tf32(x), lo = tf32(x - hi) and the product
    (lo_a hi_b + hi_a lo_b) + hi_a hi_b, the small terms first (B5's S
    and dP sum the three as separate products; every other product of
    B5, B5-bwd, B6 and B6-bwd takes them in one accumulator); with
    ``single`` one TF32 product, hi_a hi_b."""
    ah, bh = tf32(a), tf32(b)
    if single:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh
