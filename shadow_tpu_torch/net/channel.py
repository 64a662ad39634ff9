"""Pipe/socketpair channels: linked byte-queue halves, no TCP.

Counterpart of ``shadow_tpu/net/channel.py``. The reference Shadow backs
pipe()/socketpair() with a lightweight Channel descriptor, two halves
linked pairwise (shd-channel.c:134-172); here that is a pair of
PROTO_PIPE socket rows on one host, partner-linked through sk_parent.

- a write moves its whole byte count into the partner's readable stream
  and wakes the partner one nanosecond later (the epoll-notify delay);
  PIPE_BUFFER_SIZE backpressure is not modeled (delivery is immediate,
  so a standing fill never exists);
- close wakes a still-open partner with EOF, unlinks it and frees the
  half; the partner stays usable for draining until it closes itself.

Only the hosted op replay (``hosting/bridge.py``) calls these. Each
function takes all H rows and a ``[H]`` mask ``m`` of the rows that act;
a row outside the mask is left as it was.
"""

from __future__ import annotations

import torch

from ..core.rowops import col_add, radd_where, rget, rset_where
from ..engine import equeue
from ..engine.defs import EV_APP, ST_BYTES_RECV, WAKE_EOF, WAKE_SOCKET
from . import packet as P
from .socket import sock_alloc, sock_free

PROTO_PIPE = 1                 # sk_proto value (6 = tcp, 17 = udp)
PIPE_BUFFER_SIZE = 65536       # the reference's CONFIG_PIPE_BUFFER_SIZE


def _wake_partner(st, m, now, reason, partner, ln=0):
    """+1 ns wake of each masked row's partner half. WND carries the
    partner's generation in 7 bits, as the pipe open's packed pair
    does (hosting.api._bind_pipe)."""
    w = torch.zeros((st.eq_ctr.shape[0], P.PKT_WORDS), dtype=torch.int32,
                    device=st.eq_ctr.device)
    w[:, P.ACK] = reason
    w[:, P.SEQ] = partner
    w[:, P.LEN] = ln
    w[:, P.WND] = rget(st.sk_timer_gen, partner) & 0x7F
    equeue.q_push(st, m, now + 1, EV_APP, w)


def pipe_open(st, m):
    """Allocate a linked pair of pipe halves in each masked row ->
    (slot_a, slot_b, ok). A row where only the first half landed
    releases it."""
    a, ok1 = sock_alloc(st, m, PROTO_PIPE)
    b, ok2 = sock_alloc(st, m, PROTO_PIPE)
    ok = ok1 & ok2
    rset_where(st.sk_parent, a, m & ok, b)
    rset_where(st.sk_parent, b, m & ok, a)
    sock_free(st, m & ok1 & ~ok2, a)
    return a, b, ok


def pipe_write(st, m, now, slot, nbytes):
    """Move the full byte count of each masked row's write on half
    `slot` to its partner (stream cursors and ST_BYTES_RECV) and wake
    the partner with the count."""
    partner = rget(st.sk_parent, slot)
    usable = (rget(st.sk_used, slot) & (partner >= 0)
              & (rget(st.sk_proto, slot) == PROTO_PIPE))
    n_ok = torch.where(usable, nbytes.to(torch.int64).clamp(min=0), 0)
    do = m & (n_ok > 0)
    radd_where(st.sk_snd_end, slot, do, n_ok)
    radd_where(st.sk_rcv_nxt, partner, do, n_ok)
    col_add(st.stats, ST_BYTES_RECV, do, n_ok)
    _wake_partner(st, do, now, WAKE_SOCKET, partner,
                  ln=n_ok.to(torch.int32))


def pipe_close(st, m, now, slot):
    """Close half `slot` in each masked row: EOF to a still-open
    partner (unlinked first, so a recycled slot cannot alias), then
    free the half."""
    partner = rget(st.sk_parent, slot)
    live = (rget(st.sk_used, slot)
            & (rget(st.sk_proto, slot) == PROTO_PIPE))
    do = m & live
    peer = do & (partner >= 0) & rget(st.sk_used, partner)
    rset_where(st.sk_parent, partner, peer, -1)
    _wake_partner(st, peer, now, WAKE_EOF, partner)
    sock_free(st, do, slot)
