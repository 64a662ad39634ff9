"""NIC model: transmit scheduling, bandwidth accounting, packet emission.

Counterpart of ``shadow_tpu/net/nic.py``: an ``nic_busy`` horizon plus
one EV_NIC_TX event in flight per host, a transmit ring served ahead of
the sockets, loopback-vs-outbox emission, and the bounded input buffer
of ``rx_admit``. Functions take all H rows and a ``[H]`` mask of the
rows that act.

The transmit ring (UDP datagrams) is served first; otherwise the
qdisc picks one wanting TCP socket — round-robin from ``nic_rr``
(``QDISC_RR``, the default) or least recently served (``QDISC_FIFO``)
— and ``tcp_pull`` forms its next segment.
"""

from __future__ import annotations

import torch

from ..core import flow as FL
from ..core.rowops import Slot, col_add, mput, rget, rset_where, set_where
from ..core.simtime import SIMTIME_ONE_SECOND
from ..engine import equeue
from ..engine.defs import (EV_NIC_TX, EV_PKT, ST_OUTBOX_DROP,
                           ST_PKTS_DROP_BUF, ST_PKTS_SENT, ST_TXQ_DROP)
from ..obs import netscope
from . import packet as P

LOOPBACK_DELAY = 1  # ns, the reference's local-delivery task delay
_I64_MAX = 2**63 - 1


def tx_duration(nbytes, bw_bytes_per_sec):
    """Nanoseconds the uplink is busy transmitting nbytes."""
    return ((nbytes.to(torch.int64) * SIMTIME_ONE_SECOND)
            // bw_bytes_per_sec.clamp(min=1))


QDISC_FIFO = 0   # least recently served socket first
QDISC_RR = 1     # round-robin over wanting sockets


def tx_want(st):
    """[H, S] bool: TCP sockets owing the wire a packet (control bits
    or data); UDP work lives in the transmit ring."""
    from .tcp import tcp_want_tx    # tcp imports this module
    return st.sk_used & ((st.sk_ctl != 0) | tcp_want_tx(st))


def has_work(st, tcp=True):
    """[H] bool: the ring or a TCP socket owes the wire a packet (no
    socket scan with `tcp` False: the config opens no TCP socket)."""
    ring = st.txq_cnt > 0
    return ring | tx_want(st).any(1) if tcp else ring


def txq_push(st, m, pkt):
    """Enqueue each masked row's packet on its NIC transmit ring."""
    T = st.txq_pkt.shape[1]
    ok = st.txq_cnt < T
    slot = (st.txq_head + st.txq_cnt) % T
    pkt = pkt.clone()
    pkt[:, P.STATUS] |= P.DS_TXQ
    rset_where(st.txq_pkt, slot, m & ok, pkt)
    st.txq_cnt += (m & ok).to(torch.int32)
    col_add(st.stats, ST_TXQ_DROP, m & ~ok)


def emit(st, hp, m, now, pkt):
    """Hand each masked row's packet to the wire: loopback to its own
    queue, or the outbox for the window-boundary exchange. Stamps the
    per-source UID that keys the loss roll."""
    pkt = pkt.clone()
    pkt[:, P.UID] = st.pkt_ctr
    pkt[:, P.STATUS] |= P.DS_NIC_SENT
    is_loop = pkt[:, P.DST] == hp.hid

    lp = pkt.clone()
    lp[:, P.STATUS] |= P.DS_LOOPBACK
    equeue.q_push(st, m & is_loop, now + LOOPBACK_DELAY, EV_PKT, lp)

    mr = m & ~is_loop
    rp = pkt
    rp[:, P.STATUS] |= P.DS_INET
    O = st.ob_time.shape[1]
    cnt = st.ob_cnt
    ok = cnt < O
    w = Slot(cnt.clamp(max=O - 1), O).mask(mr & ok)
    mput(st.ob_pkt, w, rp)
    mput(st.ob_time, w, now)
    st.ob_cnt += (mr & ok).to(torch.int32)
    col_add(st.stats, ST_OUTBOX_DROP, mr & ~ok)

    col_add(st.stats, ST_PKTS_SENT, m)
    st.pkt_ctr += m.to(torch.int32)


def kick(st, m, now, tcp=True):
    """Ensure an EV_NIC_TX is pending on each masked row whose NIC has
    work (`tcp` as in has_work). nic_sched is set only if the push
    landed: a full queue must leave the NIC kickable."""
    need = m & has_work(st, tcp) & ~st.nic_sched
    ok = equeue.q_has_free(st)
    equeue.q_push(st, need, torch.maximum(now, st.nic_busy), EV_NIC_TX, None)
    set_where(st.nic_sched, need, ok)


def on_tx(st, hp, sh, m, now, wend, qdisc=QDISC_RR, tcp=True,
          pull_tcp=True):
    """EV_NIC_TX handler: pull one packet and emit it, or — with the
    outbox (this window's emit budget) full — retry at the window
    boundary instead of dropping. `tcp` False: the config opens no TCP
    socket (no socket scan); `pull_tcp` False skips the TCP pull (the
    caller knows no masked row can reach it; a predicate runs it under
    ``flow.when``)."""
    set_where(st.nic_sched, m, False)
    no_room = st.ob_cnt >= st.ob_time.shape[1]

    md = m & no_room
    ok = equeue.q_has_free(st)
    equeue.q_push(st, md, (now + 1).clamp(min=wend), EV_NIC_TX, None)
    set_where(st.nic_sched, md, ok)

    _tx_pull(st, hp, sh, m & ~no_room, now, qdisc, tcp, tcp and pull_tcp)


def _tx_pull(st, hp, sh, m, now, qdisc, tcp, pull_tcp):
    """Pull one packet — the transmit ring first, else the qdisc's pick
    among wanting TCP sockets — emit it, account bandwidth, and
    reschedule while work remains."""
    T = st.txq_pkt.shape[1]
    ring = m & (st.txq_cnt > 0)
    out = torch.where(ring[:, None], rget(st.txq_pkt, st.txq_head), 0)
    set_where(st.txq_head, ring, (st.txq_head + 1) % T)
    set_where(st.txq_cnt, ring, st.txq_cnt - 1)
    has_pkt = ring.clone()

    # the TCP pull writes `out` and `has_pkt` in place (it may run under
    # a conditional node)
    @FL.when(pull_tcp)
    def _():
        mt = m & ~ring
        want = tx_want(st)
        S = want.shape[1]
        ar = torch.arange(S, device=want.device)
        if qdisc == QDISC_RR:
            prio = (ar[None, :] - st.nic_rr[:, None]) % S
            sock = torch.where(want, prio, S).argmin(1)
        else:
            key = st.sk_last_tx * S + ar[None, :]
            sock = torch.where(want, key, _I64_MAX).argmin(1)
        mt = mt & want.any(1)
        from .tcp import tcp_pull
        tpkt, thas = tcp_pull(st, hp, sh, mt, now, sock)
        sent = mt & thas
        set_where(st.nic_rr, sent, ((sock + 1) % S).to(torch.int32))
        out.copy_(torch.where(sent[:, None], tpkt, out))
        has_pkt.copy_(ring | sent)

    wire = P.wire_bytes(out)
    busy = torch.where(has_pkt, tx_duration(wire, hp.bw_up).clamp(min=1), 0)
    busy_end = now + busy
    emit(st, hp, has_pkt, now, out)
    set_where(st.nic_busy, m, busy_end)

    # keep draining while work remains — only after progress, or a
    # reschedule at busy_end == now would spin on one timestamp
    more = has_work(st, tcp) & has_pkt
    ok = equeue.q_has_free(st)
    equeue.q_push(st, more, busy_end, EV_NIC_TX, None)
    set_where(st.nic_sched, more, ok)


def rx_admit(st, hp, m, now, pkt):
    """Downlink admission for each masked row: the bounded NIC input
    buffer (drop on overflow) drained at bw_down. Returns keep [H]."""
    wire = P.wire_bytes(pkt)
    bw = hp.bw_down.clamp(min=1)
    backlog_ns = (st.nic_rx_until - now).clamp(min=0)
    backlog_bytes = (backlog_ns * bw) // SIMTIME_ONE_SECOND
    keep = (backlog_bytes + wire) <= hp.nic_buf
    new_until = torch.maximum(st.nic_rx_until, now) + tx_duration(wire, bw)
    set_where(st.nic_rx_until, m & keep, new_until)
    col_add(st.stats, ST_PKTS_DROP_BUF, m & ~keep)
    # queue-delay distribution: the rx backlog each admitted packet
    # waits behind
    if netscope.on(st):
        netscope.observe(st, m & keep, netscope.NS_QUEUE, backlog_ns // 1000)
    return keep
