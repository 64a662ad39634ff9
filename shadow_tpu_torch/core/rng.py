"""Counter PRNG and the float32 log1p of the device RNG path.

Counterpart of ``shadow_tpu/core/rng.py:93-120``: a murmur3-style
avalanche over a (stream, counter) pair, the only RNG the window loop
uses. The reference computes in uint32; PyTorch cannot shift uint32 on
the CPU and int32 shifts sign-extend, so every value here is an int64
holding a u32 in [0, 2^32), masked after each multiply and xor.
Multiplies are split into 16-bit halves so no int64 product overflows.

``log1p_f32`` reproduces XLA:CPU's float32 log1p bit for bit (phold's
exponential delay goes through it): the same Cephes-style polynomial
evaluation, with XLA's fused multiply-adds emulated exactly and every
other step a single IEEE add, multiply or divide — so the CPU and CUDA
give the same bits.
"""

from __future__ import annotations

import struct

import torch

# Domain separators (shadow_tpu/core/rng.py).
DOMAIN_HOST = 1
DOMAIN_DROP = 2

_GOLDEN = 0x9E3779B9
_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a u32 constant."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _u32(x):
    """int64 u32 view of an int tensor (two's complement for negatives)."""
    return x.to(torch.int64) & _M32


def _mix32(x):
    """murmur3 finalizer (u32 avalanche) on int64-held u32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def stream_base(seed: int, domain: int) -> int:
    """The (seed, domain) half of a stream id, as a python int."""
    return (((seed & _M32) * _GOLDEN) & _M32) ^ ((domain * 0x85EBCA6B) & _M32)


def stream_of(seed: int, domain: int, ident):
    """u32 stream id (int64 tensor) for (seed, domain, per-entity id)."""
    return stream_from(stream_base(seed, domain), ident)


def stream_from(base, ident):
    """``stream_of`` from its base: an int, or an int64 tensor holding
    one base per entry of `ident` (stacked lanes, each its own seed)."""
    return _mix32(_mul32(_u32(ident), 0xC2B2AE35) ^ base)


def cheap_bits(stream, counter):
    """u32 random bits (int64 tensor) for (stream, counter)."""
    return _mix32(_u32(stream) ^ ((_u32(counter) + _GOLDEN) & _M32))


def cheap_uniform(stream, counter):
    """float32 uniform in [0, 1) from the 24 high bits."""
    return (cheap_bits(stream, counter) >> 8).to(torch.float32) * (1.0 / (1 << 24))


# --- float32 log1p, XLA:CPU's evaluation --------------------------------

def _f32(hexword: str) -> float:
    """A float32 constant written as LLVM IR prints it (a double)."""
    return struct.unpack(">d", bytes.fromhex(hexword))[0]


def fma_f32(a, b, c):
    """Exactly rounded float32 a*b + c (one rounding, as a hardware fma).

    The float64 product of two float32 values is exact. The sum is
    rounded to float64 with round-to-odd (TwoSum gives the rounding
    error; an inexact result with an even last bit steps one ulp toward
    the error), and round-to-odd at 53 bits followed by rounding to 24
    bits equals a single rounding of the exact value."""
    p = a.to(torch.float64) * (b.to(torch.float64) if torch.is_tensor(b) else b)
    c64 = c.to(torch.float64) if torch.is_tensor(c) else c
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + step, bits)
    return bits.view(torch.float64).to(torch.float32)


_FLT_MIN = _f32("3810000000000000")
_SQRT_HALF = _f32("3FE6A09E60000000")
_SMALL_X = _f32("3FDA8279A0000000")       # |x| below this: rational path
_LOG_P1 = (_f32("3FB2043760000000"), _f32("BFBD7A3700000000"),
           _f32("3FBDE4A340000000"))
_LOG_P2 = (_f32("BFBFCBA9E0000000"), _f32("3FC23D37E0000000"),
           _f32("BFC555CA00000000"))
_LOG_P3 = (_f32("3FC999D580000000"), _f32("BFCFFFFF80000000"),
           _f32("3FD5555540000000"))
_LN2_LO = _f32("BF2BD01060000000")
_LN2_HI = _f32("3FE6300000000000")
_Q = ("402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
      "4073519460000000", "406B0DB140000000", "404E0F3040000000")
_P0 = _f32("3F07BC0960000000")
_P = ("3FDFE818A0000000", "401A509F40000000", "403DE97380000000",
      "404E798EC0000000", "404C8E75A0000000", "40340A2020000000")


def _log_1p_via_log(x):
    """log(1 + x) through frexp and the Cephes logf polynomial, with
    XLA's special cases: log(0) = -inf, log(inf) = inf, log(<0) = NaN."""
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    y = x + one
    ym = torch.where(y > _FLT_MIN, y, torch.full_like(y, _FLT_MIN))
    bits = ym.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    m = ((bits & 0x7FFFFF) | 0x3F000000).to(torch.int32).view(torch.float32)
    e = ((bits >> 23) - 127).to(torch.float32) + one
    low = m < _SQRT_HALF
    t = (m - one) + torch.where(low, m, zero)
    e = e - torch.where(low, one, zero)
    z = t * t
    t3 = z * t
    a = fma_f32(fma_f32(t, _LOG_P1[0], _LOG_P1[1]), t, _LOG_P1[2])
    b = fma_f32(fma_f32(t, _LOG_P2[0], _LOG_P2[1]), t, _LOG_P2[2])
    c = fma_f32(fma_f32(t, _LOG_P3[0], _LOG_P3[1]), t, _LOG_P3[2])
    poly = fma_f32(fma_f32(fma_f32(a, t3, b), t3, c), t3, e * _LN2_LO)
    r = fma_f32(e, _LN2_HI, fma_f32(z, -0.5, t) + poly)
    rb = r.view(torch.int32)
    rb = torch.where(y > 0, rb, torch.full_like(rb, -1))          # NaN
    rb = torch.where(y == 0, torch.full_like(rb, -8388608), rb)   # -inf
    rb = torch.where(y == float("inf"), torch.full_like(rb, 0x7F800000), rb)
    return rb.view(torch.float32)


def log1p_f32(x):
    """float32 log1p(x), bit-equal to XLA:CPU's ``jnp.log1p``."""
    q = torch.ones_like(x)
    for h in _Q:
        q = fma_f32(q, x, _f32(h))
    p = torch.full_like(x, _P0)
    for h in _P:
        p = fma_f32(p, x, _f32(h))
    z = x * x
    small = x + fma_f32(z, -0.5, (x * z) * (p / q))
    return torch.where(x.abs() < _SMALL_X, small, _log_1p_via_log(x))
