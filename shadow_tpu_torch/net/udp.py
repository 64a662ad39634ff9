"""UDP: connectionless datagram sockets over the shared socket table.

Counterpart of ``shadow_tpu/net/udp.py``. A datagram is its byte count
plus a 32-bit app tag (packet AUX); payload contents are not modeled.
Functions take all H rows and a ``[H]`` mask of the rows that act.
"""

from __future__ import annotations

import torch

from ..core.constants import UDP_MAX_PAYLOAD
from ..core.rowops import col_add, radd_where, rget, rset_where
from ..engine import equeue
from ..engine.defs import EV_APP, ST_BYTES_RECV, WAKE_SOCKET
from . import nic
from . import packet as P
from .socket import alloc_eport, sock_alloc


def udp_open(st, m, port=None):
    """Create a UDP socket in each masked row, bound to `port` ([H] or
    int) or an ephemeral one -> (slot, ok)."""
    slot, ok = sock_alloc(st, m, P.PROTO_UDP)
    p = alloc_eport(st, m) if port is None else port
    rset_where(st.sk_lport, slot, m & ok, p)
    return slot, ok


def udp_sendto(st, hp, m, now, slot, dst_host, dst_port, nbytes, aux=0):
    """Send one datagram of `nbytes` payload from each masked row's
    socket `slot` to (dst_host, dst_port): formed here, queued on the
    NIC transmit ring, NIC kicked. Payload is clamped to one datagram."""
    length = nbytes.to(torch.int64).clamp(max=UDP_MAX_PAYLOAD).to(torch.int32)
    pkt = P.make(st.eq_ctr.shape[0], st.eq_ctr.device, src=hp.hid,
                 dst=dst_host, sport=rget(st.sk_lport, slot), dport=dst_port,
                 flags=P.PROTO_UDP, length=length, aux=aux,
                 status=P.DS_CREATED)
    radd_where(st.sk_snd_end, slot, m, length.to(torch.int64))
    nic.txq_push(st, m, pkt)
    # every masked row's ring now holds a packet: no socket scan needed
    nic.kick(st, m, now, tcp=False)


def udp_deliver(st, hp, sh, m, now, slot, pkt):
    """Inbound datagram for each masked row's socket `slot`: account
    bytes and wake the app (socket in SEQ, reason in ACK, the socket
    generation in WND)."""
    length = pkt[:, P.LEN].to(torch.int64)
    radd_where(st.sk_rcv_nxt, slot, m, length)
    col_add(st.stats, ST_BYTES_RECV, m, length)
    wake = pkt.clone()
    wake[:, P.SEQ] = slot
    wake[:, P.ACK] = WAKE_SOCKET
    wake[:, P.WND] = rget(st.sk_timer_gen, slot)
    equeue.q_push(st, m, now + 1, EV_APP, wake)
