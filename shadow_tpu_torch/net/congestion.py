"""TCP congestion control (aimd, reno, cubic) in float32, bit for bit.

Counterpart of ``shadow_tpu/net/congestion.py``: the same branchless
formulas selected by the runtime kind scalar (``Shared.cc_kind``), the
window counted in packets, ``ssthresh == 0`` meaning "not yet
discovered". Every argument is a ``[H]`` tensor (one socket per row).

Exactness against XLA:CPU takes three things:

- **Contractions.** XLA:CPU fuses ``a*b + c`` into one fma where the
  multiply and the add land in one fused loop. In the compiled
  ``on_ack`` there are two such sites: ``t - k2`` with ``t = dt * 1e-9``
  (a fused multiply-subtract) and the cubic target ``C*x^3 + origin``.
  Both are written with :func:`~shadow_tpu_torch.core.rng.fma_f32`;
  every other step is one IEEE operation, as XLA computes it.
- **cbrt.** XLA:CPU lowers f32 ``cbrt`` to ``copysign(powf(|x|, f32(1/3)),
  x)`` and calls the C library's ``powf``: glibc's table-driven powf
  (a 16-entry log2 table, a degree-5 polynomial, a 32-entry exp2 table;
  all in double), in its FMA build on FMA hardware, where every
  multiply-add is one fused op. :func:`cbrt_f32` runs that algorithm
  with its tables, emulating each double fma exactly
  (:func:`fma_f64`), so the CPU and the card give glibc's bits.
- **Scalar division.** ``tensor / python_float`` is a multiply by the
  reciprocal on CUDA, so every division here has a tensor divisor.

Subnormals: XLA:CPU runs with denormals flushed. In this module's
domain none arises (windows are >= 1 packet, differences of windows
are >= 2^-23), except inside cbrt, whose subnormal inputs are mapped as
the flushed powf maps them.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..core import flow as FL

from ..core.rng import fma_f32

CC_AIMD = 0
CC_RENO = 1
CC_CUBIC = 2

# The reference's cubic constants (shd-tcp-cubic.c: beta 819/1024, the
# millisecond time base giving C = 410e9 / 2^40 packets/s^3), as the
# float32 values XLA uses.
_CUBIC_BETA = float(np.float32(819.0 / 1024.0))
_CUBIC_BETA_FC = float(np.float32(1.0 + 819.0 / 1024.0))
_CUBIC_C = float(np.float32(410.0 * 1e9 / float(1 << 40)))
_INV_CUBIC_C = float(np.float32(1.0) / np.float32(_CUBIC_C))
_NS = float(np.float32(1e-9))
_MS_PER_NS = float(np.float32(1e-6))
_THIRD = float(np.float32(1.0 / 3.0))


def _full(like, v):
    return torch.full_like(like, v)


def on_ack(kind, cwnd, ssthresh, wmax, epoch, k, npkts, now, srtt_ns,
           live=None):
    """Congestion avoidance on a new-data ACK -> (cwnd', epoch', k').

    `npkts` full segments newly acked, `now` the time in ns, `srtt_ns`
    the min RTT sample (<= 0: the reference's 100 ms default). `live`
    ([H] bool, default all) marks the rows whose result is used: cbrt
    runs only when one of them starts an epoch in avoidance (whatever
    the kind: k' is written for every kind, as the reference does)."""
    f32 = torch.float32
    npkts_f = npkts.to(f32)
    in_ss = (ssthresh == 0.0) | (cwnd < ssthresh)
    ss_cwnd = cwnd + npkts_f
    cmax = torch.maximum(cwnd, _full(cwnd, 1.0))
    add_cwnd = cwnd + (npkts_f * npkts_f) / cmax

    fresh = epoch < 0
    if not torch.is_tensor(now):
        now = torch.full((), now, dtype=torch.int64, device=cwnd.device)
    epoch2 = torch.where(fresh, now, epoch)
    gap = torch.maximum(wmax - cwnd, torch.zeros_like(cwnd))
    need = fresh & ~in_ss if live is None else fresh & ~in_ss & live
    # XLA folds the division by the constant into a multiply by its
    # float32 reciprocal
    k2 = torch.where(fresh, _cbrt_where(need, gap * _INV_CUBIC_C), k)
    dt = (now - epoch2).to(f32)
    x = fma_f32(dt, _NS, -k2)                       # t - k2, fused
    origin = torch.where(wmax > 0.0, wmax, cwnd)
    target = fma_f32((x * x) * x, _CUBIC_C, origin)  # C x^3 + origin
    srtt_ms = torch.where(srtt_ns > 0, srtt_ns.to(f32) * _MS_PER_NS,
                          _full(cwnd, 100.0))
    rate_cap = (npkts_f * srtt_ms) / (cmax * 25.0)
    cubic_step = torch.where(target > cwnd,
                             torch.minimum((target - cwnd) / cmax, rate_cap),
                             _full(cmax, 0.01) / cmax)
    cubic_cwnd = cwnd + torch.minimum(cubic_step, npkts_f)

    avoid = torch.where(kind == CC_CUBIC, cubic_cwnd, add_cwnd)
    return (torch.where(in_ss, ss_cwnd, avoid),
            torch.where(in_ss, epoch, epoch2),
            torch.where(in_ss, k, k2))


def on_loss(kind, cwnd, ssthresh, wmax):
    """Multiplicative decrease on a loss -> (cwnd', ssthresh', wmax',
    epoch' = -1): halve for aimd/reno, beta for cubic with fast
    convergence on wmax."""
    half = torch.maximum(torch.ceil(cwnd / _full(cwnd, 2.0)),
                         _full(cwnd, 1.0))
    wmax2 = torch.where(cwnd < wmax,
                        (cwnd * _CUBIC_BETA_FC) / _full(cwnd, 2.0), cwnd)
    cub = torch.maximum(cwnd * _CUBIC_BETA, _full(cwnd, 2.0))
    cubic = kind == CC_CUBIC
    new_wnd = torch.where(cubic, cub, half)
    return (new_wnd, new_wnd, torch.where(cubic, wmax2, wmax),
            torch.full_like(cwnd, -1, dtype=torch.int64))


def _cbrt_where(need, x):
    """cbrt_f32(x) where some row needs it, zeros otherwise — the value
    is only selected on those rows. The skip is a ``flow.when`` on
    ``need.any()``: a host read under the eager flow, a conditional
    node in a captured chunk."""
    out = torch.zeros_like(x)

    @FL.when(need.any())
    def _():
        out.copy_(cbrt_f32(x))
    return out


# --- exact double fma -------------------------------------------------------

def _split(a):
    """Veltkamp split: a = hi + lo, each with at most 26 bits."""
    c = a * 134217729.0
    hi = c - (c - a)
    return hi, a - hi


def fma_f64(a, b, c):
    """Correctly rounded float64 a*b + c from IEEE double ops only.

    Dekker's exact product p + e = a*b, TwoSum s + t = p + c, then
    round-to-odd of t + e and one round-to-nearest of s plus that (the
    Boldo-Melquiond emulated fma). Exact for operands far from
    overflow and underflow, as all of :func:`cbrt_f32`'s are."""
    a = a if torch.is_tensor(a) else torch.full_like(b, a)
    b = b if torch.is_tensor(b) else torch.full_like(a, b)
    c = c if torch.is_tensor(c) else torch.full_like(a, c)
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = (((ah * bh - p) + ah * bl) + al * bh) + al * bl
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    v = t + e
    bv = v - t
    ev = (t - (v - bv)) + (e - bv)
    bits = v.view(torch.int64)
    step = torch.where((ev > 0) == (v > 0), 1, -1)
    bits = torch.where((ev != 0) & ((bits & 1) == 0), bits + step, bits)
    return s + bits.view(torch.float64)


# --- glibc powf(|x|, f32(1/3)) ----------------------------------------------

def _hexf(h: str) -> float:
    return float.fromhex(h)


# __powf_log2_data: (invc, logc) per 16 subintervals, and the log2 poly
_LOG2_TAB = (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", "0x0.0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2"),
)
_LOG2_A = tuple(_hexf(h) for h in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0"))
# __exp2f_data: 2^(i/32) with i << 47 taken out of the bits, the shift
# that rounds to 1/32, and the exp2 poly
_EXP2_SHIFT = _hexf("0x1.8p+47")
_EXP2_C = tuple(_hexf(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
_SHIFT_BITS = struct.unpack("<q", struct.pack("<d", _EXP2_SHIFT))[0]


def _exp2_tab_bits():
    out = []
    for i in range(32):
        v = struct.unpack("<q", struct.pack("<d", 2.0 ** (i / 32)))[0]
        out.append(v - (i << 47))
    return out


_TABLES = {}


def _tables(device):
    key = str(device)
    if key not in _TABLES:
        f64 = dict(dtype=torch.float64, device=device)
        _TABLES[key] = (
            torch.tensor([_hexf(a) for a, _ in _LOG2_TAB], **f64),
            torch.tensor([_hexf(b) for _, b in _LOG2_TAB], **f64),
            torch.tensor(_exp2_tab_bits(), dtype=torch.int64, device=device))
    return _TABLES[key]


def cbrt_f32(x):
    """float32 cbrt, bit-equal to XLA:CPU's ``jnp.cbrt``:
    copysign(glibc powf(|x|, f32(1/3)), x), denormals flushed."""
    invc_t, logc_t, exp2_t = _tables(x.device)
    ix = x.view(torch.int32).to(torch.int64) & 0x7FFFFFFF
    zero = ix == 0
    special = ix >= 0x7F800000                      # inf and NaN
    # a flushed subnormal reaches powf's normalisation as 0 * 2^23,
    # which leaves 0 - (23 << 23) in the bits
    ix = torch.where(ix < 0x00800000, 0xF4800000, ix)

    # log2(x) = log1p(z/c - 1)/ln2 + log2(c) + k
    tmp = (ix - 0x3F330000) & 0xFFFFFFFF
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    iz = (ix - top) & 0xFFFFFFFF
    k = torch.where(top >= 1 << 31, top - (1 << 32), top) >> 23
    z = iz.to(torch.int32).view(torch.float32).to(torch.float64)
    r = fma_f64(z, invc_t[i], -1.0)
    y0 = logc_t[i] + k.to(torch.float64)
    r2 = r * r
    a = _LOG2_A
    y = fma_f64(a[0], r, a[1])
    p = fma_f64(a[2], r, a[3])
    r4 = r2 * r2
    q = fma_f64(r, a[4], y0)
    q = fma_f64(r2, p, q)
    logx = fma_f64(y, r4, q)
    ylogx = logx * _THIRD

    # exp2(ylogx) = 2^(n/32) * 2^r, |r| <= 1/64
    kd = ylogx + _EXP2_SHIFT
    n = kd.view(torch.int64) - _SHIFT_BITS
    kd = kd - _EXP2_SHIFT
    r = ylogx - kd
    s = (exp2_t[n & 31] + n * (1 << 47)).view(torch.float64)
    c = _EXP2_C
    zz = fma_f64(c[0], r, c[1])
    r2 = r * r
    y = fma_f64(c[2], r, 1.0)
    y = fma_f64(zz, r2, y)
    out = (y * s).to(torch.float32)

    out = torch.where(zero, torch.zeros_like(out), out)
    out = torch.where(special, x.abs(), out)
    return torch.copysign(out, x)
