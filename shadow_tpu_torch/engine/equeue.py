"""Per-host event queue operations on batched rows.

Counterpart of ``shadow_tpu/engine/equeue.py``. A host's queue is a
fixed-capacity unsorted slot array; "pop min" is a lexicographic
(time, seq) reduction that matches the reference's event_compare
order. Every function takes all H rows and a ``[H]`` bool mask ``m``:
only rows where ``m`` holds change, which is what the reference's
row-level code under ``vmap``/``lax.cond`` computes.

``torch.argmax``/``argmin`` return the first index of the extremum, as
``jnp`` does; they do not take bool, so masks are cast first.
"""

from __future__ import annotations

import torch

from ..core.rowops import Slot, col_add, mput, set_where
from ..core.simtime import SIMTIME_MAX
from .defs import EV_NULL, ST_EQ_FULL_LOCAL

_I32_MAX = 2**31 - 1


def q_push(st, m, t, kind, pkt):
    """Push an event into the first free slot of each masked row's
    queue. A full queue drops the event and counts ST_EQ_FULL_LOCAL;
    eq_ctr advances either way."""
    free = st.eq_time == SIMTIME_MAX
    has_free = free.any(1)
    w = m & has_free
    # one-hot of each row's first free slot, where m holds
    first = free & (torch.cumsum(free, 1) == 1) & w.unsqueeze(1)
    mput(st.eq_time, first, t)
    mput(st.eq_seq, first, st.eq_ctr)
    mput(st.eq_kind, first, kind)
    mput(st.eq_pkt, first, 0 if pkt is None else pkt)
    st.eq_ctr += m.to(torch.int32)
    low = (torch.minimum(st.eq_next, t) if torch.is_tensor(t)
           else st.eq_next.clamp(max=t))
    set_where(st.eq_next, w, low)
    col_add(st.stats, ST_EQ_FULL_LOCAL, m & ~has_free)


def q_has_free(st):
    """[H] True where a push right now would land."""
    return (st.eq_time == SIMTIME_MAX).any(1)


def q_min(st):
    """Lexicographic (time, seq) minimum per row -> (slot, time), read
    from the cached row minimum eq_next (a copy: the queue functions
    update eq_next in place)."""
    tmin = st.eq_next.clone()
    cand = st.eq_time == tmin[:, None]
    seq_key = torch.where(cand, st.eq_seq, _I32_MAX)
    return seq_key.argmin(1), tmin


def q_clear_slot(st, m, slot):
    """Free each masked row's popped slot and recompute its cached row
    minimum. Only time and kind are reset (payload bytes stay)."""
    w = Slot(slot, st.eq_time.shape[1]).mask(m)
    mput(st.eq_time, w, SIMTIME_MAX)
    mput(st.eq_kind, w, EV_NULL)
    set_where(st.eq_next, m, st.eq_time.min(1).values)
