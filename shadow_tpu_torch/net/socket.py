"""Socket table operations on batched rows.

Counterpart of ``shadow_tpu/net/socket.py``: a fixed socket table of
column tensors per host; allocation claims a free row and the NIC's
(protocol, port) -> socket demux is a vectorized match over the table.
Functions take all H rows and a ``[H]`` mask of the rows that act.
"""

from __future__ import annotations

import torch

from ..core.constants import (MAX_PORT, MIN_RANDOM_PORT, RECV_BUFFER_SIZE,
                              SEND_BUFFER_SIZE, TCP_RTO_INIT)
from ..core.rowops import Slot, mput, set_where
from .packet import PROTO_TCP

# TCP states (shd-tcp.c:10-15).
TCPS_CLOSED = 0
TCPS_LISTEN = 1
TCPS_SYN_SENT = 2
TCPS_SYN_RECEIVED = 3
TCPS_ESTABLISHED = 4
TCPS_FIN_WAIT_1 = 5
TCPS_FIN_WAIT_2 = 6
TCPS_CLOSE_WAIT = 7
TCPS_CLOSING = 8
TCPS_LAST_ACK = 9
TCPS_TIME_WAIT = 10

# Pending control transmissions (sk_ctl): the header-only packets a
# socket owes the wire, pulled by the NIC ahead of data.
CTL_SYN = 1
CTL_SYNACK = 2
CTL_ACKNOW = 4
CTL_FIN = 8
CTL_RST = 16

_I64_MAX = 2**63 - 1

# (field, value) reset by sock_alloc on the claimed row, in the
# reference's order; None = the allocating process (app_proc).
_ALLOC_RESET = (
    ("sk_used", True), ("sk_proto", None), ("sk_state", TCPS_CLOSED),
    ("sk_lport", 0), ("sk_rport", 0), ("sk_rhost", -1),
    ("sk_parent", -1), ("sk_snd_una", 0), ("sk_snd_nxt", 0),
    ("sk_snd_max", 0), ("sk_snd_end", 0), ("sk_rcv_nxt", 0),
    ("sk_ooo_s", -1), ("sk_ooo_e", -1), ("sk_sack_s", -1),
    ("sk_sack_e", -1), ("sk_hole_end", 0), ("sk_rex_nxt", 0),
    ("sk_peer_fin", -1), ("sk_fin_acked", False),
    ("sk_close_after", False), ("sk_cwnd", 0.0), ("sk_ssthresh", 0.0),
    ("sk_srtt", -1), ("sk_rtt_min", -1), ("sk_rttvar", 0),
    ("sk_rto", TCP_RTO_INIT), ("sk_rto_deadline", 0),
    ("sk_timer_on", False), ("sk_dupacks", 0), ("sk_rtt_seq", -1),
    ("sk_rtt_time", 0), ("sk_ctl", 0), ("sk_peer_rwnd", RECV_BUFFER_SIZE),
    ("sk_sndbuf", SEND_BUFFER_SIZE), ("sk_rcvbuf", RECV_BUFFER_SIZE),
    ("sk_hs_time", 0), ("sk_last_tx", 0), ("sk_syn_tag", 0),
    ("sk_app_ref", -1), ("sk_cc_wmax", 0.0), ("sk_cc_epoch", -1),
    ("sk_cc_k", 0.0),
)


def sock_alloc(st, m, proto: int):
    """Claim a free socket row in each masked host -> (slot, ok).

    Under table pressure the TIME_WAIT socket with the oldest service
    stamp is recycled (tw_reuse), as in the reference."""
    free = ~st.sk_used
    tw = st.sk_used & (st.sk_state == TCPS_TIME_WAIT)
    any_free = free.any(1)
    ok = any_free | tw.any(1)
    tw_rank = torch.where(tw, st.sk_last_tx, _I64_MAX)
    slot = torch.where(any_free, free.to(torch.int32).argmax(1),
                       tw_rank.argmin(1))
    w = Slot(slot, st.sk_used.shape[1]).mask(m & ok)
    for name, val in _ALLOC_RESET:
        mput(getattr(st, name), w, proto if val is None else val)
    st.sk_timer_gen += w.to(torch.int32)
    mput(st.sk_proc, w, st.app_proc)
    return slot, ok


def sock_free(st, m, slot):
    """Release each masked row's socket `slot` (descriptor close)."""
    sl = slot if isinstance(slot, Slot) else Slot(slot, st.sk_used.shape[1])
    w = sl.mask(m)
    for name, val in (("sk_used", False), ("sk_proto", 0),
                      ("sk_state", TCPS_CLOSED), ("sk_ctl", 0),
                      ("sk_rto_deadline", 0), ("sk_timer_on", False),
                      ("sk_app_ref", -1)):
        mput(getattr(st, name), w, val)
    st.sk_timer_gen += w.to(torch.int32)


def alloc_eport(st, m):
    """Allocate an ephemeral local port per masked row: a per-host
    cursor with a short probe against the table."""
    span = MAX_PORT - MIN_RANDOM_PORT
    p = st.next_eport
    for _ in range(4):
        used = (st.sk_used & (st.sk_lport == p[:, None])).any(1)
        p = torch.where(used, MIN_RANDOM_PORT + (p + 1 - MIN_RANDOM_PORT) % span,
                        p)
    set_where(st.next_eport, m, MIN_RANDOM_PORT
              + (p + 1 - MIN_RANDOM_PORT) % span)
    return p


def sock_demux(st, src_host, sport, dport, proto: int):
    """[H] socket owning each row's inbound packet, or -1: exact
    4-tuple match first, then a bound-unconnected (UDP) or listening
    (TCP) socket on the destination port."""
    usable = st.sk_used & (st.sk_proto == proto)
    port_ok = usable & (st.sk_lport == dport[:, None])
    exact = (port_ok & (st.sk_rhost == src_host[:, None])
             & (st.sk_rport == sport[:, None]))
    if proto == PROTO_TCP:
        fallback = port_ok & (st.sk_state == TCPS_LISTEN)
    else:
        fallback = port_ok & (st.sk_rhost == -1)
    first_exact = exact.to(torch.int32).argmax(1)
    first_fb = fallback.to(torch.int32).argmax(1)
    return torch.where(exact.any(1), first_exact,
                       torch.where(fallback.any(1), first_fb, -1))
