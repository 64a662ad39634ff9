"""SACK scoreboard: fixed-capacity sets of disjoint byte ranges.

Counterpart of ``shadow_tpu/net/sack.py``. A set is at most K disjoint,
non-adjacent ``[start, end)`` stream ranges held in two int64 tensors
``s, e`` of shape ``[..., K]`` (start -1 = empty slot, empties sorted
last). Every function is batched over the leading dims; arguments such
as ``ns``/``ne``/``rcv``/``x`` are ``[...]``. Both sides of SACK state
use it: the receiver's out-of-order runs above rcv_nxt and the
sender's peer-reported sacked runs above snd_una.

Wire encoding: the two lowest ranges ride each ACK (AUX and APP words)
as 15-bit (offset, length) pairs in MSS units, shrunk to segment
alignment so the advertised range is a subset of what is held.
"""

from __future__ import annotations

import torch

from ..core.constants import TCP_MSS

K = 4
_INF = 2**62


def _sorted_pack(s, e):
    """Sort ranges ascending by start, empty slots (-1) last (stable,
    as XLA's sort is)."""
    key = torch.where(s < 0, _INF, s)
    order = torch.sort(key, dim=-1, stable=True).indices
    return s.gather(-1, order), e.gather(-1, order)


def insert_counted(s, e, ns, ne):
    """Add [ns, ne) (no-op when ne <= ns), merging overlapping or
    touching ranges; keeps the K lowest -> (s, e, dropped) with dropped
    = 1 where a valid range fell off the top."""
    valid = s >= 0
    nsk, nek = ns[..., None], ne[..., None]
    new_ok = ne > ns
    ov = valid & new_ok[..., None] & (nsk <= e) & (nek >= s)
    ms = torch.minimum(ns, torch.where(ov, s, _INF).amin(-1))
    me = torch.maximum(ne, torch.where(ov, e, -1).amax(-1))
    keep = valid & ~ov
    cs = torch.cat([torch.where(keep, s, -1),
                    torch.where(new_ok, ms, -1)[..., None]], -1)
    ce = torch.cat([torch.where(keep, e, -1),
                    torch.where(new_ok, me, -1)[..., None]], -1)
    cs, ce = _sorted_pack(cs, ce)
    dropped = (cs[..., K] >= 0).to(torch.int32)
    return cs[..., :K], ce[..., :K], dropped


def insert(s, e, ns, ne):
    return insert_counted(s, e, ns, ne)[:2]


def consume(s, e, rcv):
    """Advance the in-order cursor through every range it reaches ->
    (s, e, rcv')."""
    for _ in range(K):
        hit = (s >= 0) & (s <= rcv[..., None])
        rcv = torch.maximum(rcv, torch.where(hit, e, -1).amax(-1))
        s = torch.where(hit, -1, s)
        e = torch.where(hit, -1, e)
    s, e = _sorted_pack(s, e)
    return s, e, rcv


def drop_below(s, e, lo):
    """Remove ranges at or below `lo` and clip the one it cuts."""
    valid = s >= 0
    lok = lo[..., None]
    gone = valid & (e <= lok)
    s = torch.where(gone, -1, torch.where(valid, torch.maximum(s, lok), s))
    e = torch.where(gone, -1, e)
    return _sorted_pack(s, e)


def skip(x, s, e):
    """First offset >= x not inside any range."""
    xk = x[..., None]
    inside = (s >= 0) & (xk >= s) & (xk < e)
    return torch.maximum(x, torch.where(inside, e, -1).amax(-1))


def next_start_after(x, s, e):
    """Smallest range start > x; _INF if none."""
    cand = torch.where((s >= 0) & (s > x[..., None]), s, _INF)
    return cand.amin(-1)


def max_end(s, e):
    """Highest sacked offset, -1 when the set is empty."""
    return torch.where(s >= 0, e, -1).amax(-1)


def lost_bound(s, e, una, hole_end):
    """Upper bound of inferably lost bytes for fast recovery: the
    highest sacked run, or one segment past the cumulative ack with no
    SACK information, clipped to the recovery point."""
    me = max_end(s, e)
    return torch.minimum(hole_end, torch.where(me > 0, me, una + TCP_MSS))


def _encode_one(s_i, e_i, ack):
    has = s_i >= 0
    rel_raw = torch.div(s_i - ack + TCP_MSS - 1, TCP_MSS,
                        rounding_mode="floor")
    rel = rel_raw.clamp(0, 0x7FFF)
    a_s = ack + rel * TCP_MSS
    ln = torch.div(e_i - a_s, TCP_MSS, rounding_mode="floor").clamp(0, 0x7FFF)
    ok = has & (ln > 0) & (rel_raw <= 0x7FFF)
    word = (rel.to(torch.int32) << 1) | (ln.to(torch.int32) << 16)
    return torch.where(ok, word, 0)


def encode2(s, e, ack):
    """The two lowest ranges as packed words for AUX and APP (0 = no
    block); bit 0 of the first stays clear for the FINACK flag."""
    return (_encode_one(s[..., 0], e[..., 0], ack),
            _encode_one(s[..., 1], e[..., 1], ack))


def decode(word, ack, hi):
    """Packed word -> (start, end) clipped to [ack, hi); (-1, -1) when
    absent."""
    rel = ((word >> 1) & 0x7FFF).to(torch.int64)
    ln = ((word >> 16) & 0x7FFF).to(torch.int64)
    s = ack + rel * TCP_MSS
    e = torch.minimum(s + ln * TCP_MSS, hi)
    ok = (ln > 0) & (e > s)
    return torch.where(ok, s, -1), torch.where(ok, e, -1)
