"""TCP: the connection state machine over the socket table.

Counterpart of ``shadow_tpu/net/tcp.py``: the 11-state machine in
sk_state, listener children allocated on SYN, stream-offset windows,
one outstanding EV_TCP_TIMER per socket with a desired-deadline
re-check (RFC 6298 RTO, go-back-N), SACK-driven fast recovery
(``net/sack.py``), the aimd/reno/cubic family (``net/congestion.py``)
and the FIN/TIME_WAIT close. Same names and the same order of every
read and write as the reference.

The reference's functions act on one host under ``vmap`` and branch
with ``lax.cond``. Here each takes all H rows, a ``[H]`` mask ``m`` of
the rows that act, and a ``[H]`` socket index ``slot``; a branch is a
mask, and state is written in place where it holds. The wire's SEQ,
ACK and LEN words are int32: int64 stream offsets wrap into them as
the reference's ``astype(int32)`` does (``Tensor.to(torch.int32)``
truncates the same way on the CPU and the card).
"""

from __future__ import annotations

import torch

from ..core.constants import (RECV_BUFFER_MIN_SIZE, SEND_BUFFER_MIN_SIZE,
                              TCP_CLOSE_TIMER_DELAY, TCP_MSS, TCP_RTO_MAX,
                              TCP_RTO_MIN)
from ..core.rowops import Slot, col_add, mput
from ..engine import equeue
from ..engine.defs import (EV_APP, EV_TCP_CLOSE, EV_TCP_TIMER, ST_BYTES_RECV,
                           ST_BYTES_SENT, ST_RETRANSMIT, ST_SACK_RENEGE,
                           ST_SOCK_FAIL, WAKE_ACCEPT, WAKE_CONNECTED,
                           WAKE_EOF, WAKE_SENT, WAKE_SOCKET)
from ..obs import netscope
from . import congestion as CC
from . import nic
from . import packet as P
from . import sack
from .socket import (CTL_ACKNOW, CTL_FIN, CTL_RST, CTL_SYN, CTL_SYNACK,
                     TCPS_CLOSE_WAIT, TCPS_CLOSED, TCPS_CLOSING,
                     TCPS_ESTABLISHED, TCPS_FIN_WAIT_1, TCPS_FIN_WAIT_2,
                     TCPS_LAST_ACK, TCPS_LISTEN, TCPS_SYN_RECEIVED,
                     TCPS_SYN_SENT, TCPS_TIME_WAIT, alloc_eport, sock_alloc,
                     sock_free)

_I32 = torch.int32
_I64 = torch.int64

# AUX bit on ACK-bearing segments: "your FIN is fully received".
AUX_FINACK = 1


def _sl(st, slot):
    """A socket index per row, prepared for many reads and writes."""
    return slot if isinstance(slot, Slot) else Slot(slot, st.sk_used.shape[1])


def _set(st, sl, m, **kw):
    """st.<field>[h, slot[h]] = value[h] where m[h], per kwarg."""
    w = sl.mask(m)
    for f, v in kw.items():
        mput(getattr(st, f), w, v)


def _g(st, f, sl):
    return sl.get(getattr(st, f))


def _timer_ev(slot, gen):
    """[H, W] timer/close event payload: SEQ = socket, ACK = generation."""
    ev = torch.zeros((slot.shape[0], P.PKT_WORDS), dtype=_I32,
                     device=slot.device)
    ev[:, P.SEQ] = slot
    ev[:, P.ACK] = gen
    return ev


def _wake(st, m, now, reason, sl, pkt, ln=0, aux=0):
    """Schedule an EV_APP for each masked row: the segment's words with
    the reason in ACK, the socket in SEQ, `ln`/`aux` in LEN/AUX and the
    socket generation in WND."""
    w = pkt.clone()
    w[:, P.ACK] = reason
    w[:, P.SEQ] = sl.idx
    w[:, P.LEN] = ln
    w[:, P.AUX] = aux
    w[:, P.WND] = _g(st, "sk_timer_gen", sl)
    equeue.q_push(st, m, now + 1, EV_APP, w)


def _arm_timer(st, m, sl, now):
    """Ensure the retransmission timer fires at now + rto: move the
    deadline, and push an EV_TCP_TIMER only when none is in flight."""
    deadline = now + _g(st, "sk_rto", sl)
    need = m & ~_g(st, "sk_timer_on", sl)
    _set(st, sl, m, sk_rto_deadline=deadline)
    ok = equeue.q_has_free(st)
    equeue.q_push(st, need, deadline, EV_TCP_TIMER,
                  _timer_ev(sl.idx, _g(st, "sk_timer_gen", sl)))
    # only mark armed if the push landed (full queue = lost wakeup)
    _set(st, sl, need, sk_timer_on=ok)


def _stop_timer(st, m, sl):
    _set(st, sl, m, sk_rto_deadline=0)


# --- App-facing calls ------------------------------------------------------

def tcp_listen(st, m, port):
    """Create a listening socket on `port` in each masked row ->
    (slot, ok)."""
    slot, ok = sock_alloc(st, m, P.PROTO_TCP)
    _set(st, _sl(st, slot), m & ok, sk_state=TCPS_LISTEN, sk_lport=port)
    return slot, ok


def tcp_connect(st, hp, sh, m, now, dst_host, dst_port, tag=0):
    """Active open to (dst_host, dst_port) -> (slot, ok): SYN via the
    NIC, WAKE_CONNECTED on completion. `tag` rides the SYN's APP word
    to the acceptor."""
    slot, ok = sock_alloc(st, m, P.PROTO_TCP)
    lport = alloc_eport(st, m)
    sl = _sl(st, slot)
    w = m & ok
    _set(st, sl, w, sk_state=TCPS_SYN_SENT, sk_lport=lport,
         sk_rport=dst_port, sk_rhost=dst_host, sk_ctl=CTL_SYN,
         sk_cwnd=sh.tcp_init_wnd, sk_ssthresh=sh.tcp_ssthresh0,
         sk_hs_time=now, sk_syn_tag=tag)
    _arm_timer(st, w, sl, now)
    nic.kick(st, w, now)
    col_add(st.stats, ST_SOCK_FAIL, m & ~ok)
    return slot, ok


def tcp_write(st, m, now, slot, nbytes):
    """The app writes `nbytes` to the stream (byte counts only)."""
    sl = _sl(st, slot)
    _set(st, sl, m, sk_snd_end=_g(st, "sk_snd_end", sl) + nbytes)
    nic.kick(st, m, now)


def tcp_close_call(st, m, now, slot):
    """App close: FIN after in-flight data drains (close_after), or an
    immediate free for listeners and unconnected sockets."""
    sl = _sl(st, slot)
    state = _g(st, "sk_state", sl)
    instant = ((state == TCPS_LISTEN) | (state == TCPS_CLOSED) |
               (state == TCPS_SYN_SENT) | (state == TCPS_SYN_RECEIVED))
    sock_free(st, m & instant, sl)
    md = m & ~instant
    _set(st, sl, md, sk_close_after=True)
    nic.kick(st, md, now)


def tcp_abort_call(st, m, now, slot):
    """Abortive close: RST toward an established peer, an immediate
    free otherwise."""
    sl = _sl(st, slot)
    used = _g(st, "sk_used", sl)
    state = _g(st, "sk_state", sl)
    connected = (used & (_g(st, "sk_proto", sl) == P.PROTO_TCP) &
                 (state >= TCPS_ESTABLISHED) & (state != TCPS_TIME_WAIT) &
                 (_g(st, "sk_rhost", sl) >= 0))
    mr = m & connected
    _set(st, sl, mr, sk_ctl=_g(st, "sk_ctl", sl) | CTL_RST,
         sk_close_after=False)
    nic.kick(st, mr, now)
    sock_free(st, m & ~connected & used, sl)


# --- Transmit path (NIC pull) ----------------------------------------------

def _fin_wait_states(state):
    return ((state == TCPS_FIN_WAIT_1) | (state == TCPS_CLOSING) |
            (state == TCPS_LAST_ACK))


def _data_tx_states(state):
    """Open states plus the FIN-sent ones: after an RTO rewinds
    snd_nxt, data below the FIN must still go out."""
    return ((state == TCPS_ESTABLISHED) | (state == TCPS_CLOSE_WAIT) |
            _fin_wait_states(state))


def _win(cwnd, peer_rwnd):
    """Effective send window in bytes: min(cwnd, peer window)."""
    return torch.minimum(cwnd.to(_I64) * TCP_MSS, peer_rwnd.clamp(min=1))


def tcp_want_tx(st):
    """[H, S] bool: sockets owing the wire a data segment, a pending
    fast retransmission or a first FIN (control bits are covered by
    sk_ctl != 0 in nic.tx_want)."""
    state = st.sk_state
    open_tx = (state == TCPS_ESTABLISHED) | (state == TCPS_CLOSE_WAIT)
    data_tx = _data_tx_states(state)
    win = _win(st.sk_cwnd, st.sk_peer_rwnd)
    rex_tgt = sack.skip(st.sk_rex_nxt, st.sk_sack_s, st.sk_sack_e)
    lost_end = sack.lost_bound(st.sk_sack_s, st.sk_sack_e, st.sk_snd_una,
                               st.sk_hole_end)
    rex_ok = data_tx & (st.sk_hole_end > 0) & (rex_tgt < lost_end)
    data_ok = (data_tx & (st.sk_snd_nxt < st.sk_snd_end) &
               (st.sk_snd_nxt < st.sk_snd_una + win))
    fin_due = (open_tx & st.sk_close_after &
               (st.sk_snd_nxt == st.sk_snd_end))
    return (st.sk_proto == P.PROTO_TCP) & (rex_ok | data_ok | fin_due)


def _finack_aux(st, sl):
    """-> (aux, app) words: FINACK flag plus the two most urgent SACK
    blocks of the receive scoreboard."""
    pf = _g(st, "sk_peer_fin", sl)
    rcv = _g(st, "sk_rcv_nxt", sl)
    got_fin = (pf >= 0) & (rcv >= pf)
    b1, b2 = sack.encode2(_g(st, "sk_ooo_s", sl), _g(st, "sk_ooo_e", sl),
                          rcv)
    return torch.where(got_fin, AUX_FINACK, 0).to(_I32) | b1, b2


def tcp_pull(st, hp, sh, m, now, slot):
    """NIC pull: each masked row's socket `slot` produces its next
    packet (RST > SYN > SYNACK > data > FIN > pure ACK) -> (pkt, has)."""
    sl = _sl(st, slot)
    state = _g(st, "sk_state", sl)
    ctl = _g(st, "sk_ctl", sl)
    open_tx = (state == TCPS_ESTABLISHED) | (state == TCPS_CLOSE_WAIT)
    snd_nxt = _g(st, "sk_snd_nxt", sl)
    snd_end = _g(st, "sk_snd_end", sl)
    snd_una = _g(st, "sk_snd_una", sl)
    limit = snd_una + _win(_g(st, "sk_cwnd", sl),
                           _g(st, "sk_peer_rwnd", sl))
    data_tx = _data_tx_states(state)
    hole_end = _g(st, "sk_hole_end", sl)
    sck_s = _g(st, "sk_sack_s", sl)
    sck_e = _g(st, "sk_sack_e", sl)
    rex_nxt = sack.skip(_g(st, "sk_rex_nxt", sl), sck_s, sck_e)
    lost_end = sack.lost_bound(sck_s, sck_e, snd_una, hole_end)
    rex_pending = data_tx & (hole_end > 0) & (rex_nxt < lost_end)
    can_new = data_tx & (snd_nxt < snd_end) & (snd_nxt < limit)
    can_data = rex_pending | can_new

    fin_first = open_tx & _g(st, "sk_close_after", sl) & (snd_nxt == snd_end)
    fin_rexmit = ((ctl & CTL_FIN) != 0) & _fin_wait_states(state)
    p_fin = (fin_first | fin_rexmit) & ~can_data
    sel = torch.full_like(state, -1)
    for code, cond in ((5, (ctl & CTL_ACKNOW) != 0), (4, p_fin),
                       (3, can_data), (2, (ctl & CTL_SYNACK) != 0),
                       (1, (ctl & CTL_SYN) != 0), (0, (ctl & CTL_RST) != 0)):
        sel = torch.where(cond, code, sel)
    has = sel >= 0
    hs = (sel == 1) | (sel == 2)

    ack_no = _g(st, "sk_rcv_nxt", sl).to(_I32)
    wnd = _g(st, "sk_rcvbuf", sl).clamp(max=2**31 - 1).to(_I32)
    aux, sack2 = _finack_aux(st, sl)
    # handshake segments carry this end's bandwidths (KiB/s, 16 bits
    # each) for the peer's buffer autotuning
    bw_stamp = (((hp.bw_up >> 10).clamp(max=0xFFFF).to(_I32) << 16) |
                (hp.bw_down >> 10).clamp(max=0xFFFF).to(_I32))
    aux = torch.where(hs, bw_stamp, aux)

    rex_cap = torch.minimum(lost_end,
                            sack.next_start_after(rex_nxt, sck_s, sck_e))
    ln = torch.where(sel == 3,
                     torch.where(rex_pending,
                                 (rex_cap - rex_nxt).clamp(max=TCP_MSS),
                                 (torch.minimum(snd_end, limit)
                                  - snd_nxt).clamp(max=TCP_MSS)),
                     0).to(_I32)
    seq = torch.where(sel == 3, torch.where(rex_pending, rex_nxt, snd_nxt),
                      torch.where(sel == 4, snd_end, 0)).to(_I32)
    flags = (P.PROTO_TCP | torch.where(hs, P.F_SYN, 0)
             | torch.where(sel == 0, P.F_RST, 0)
             | torch.where(sel == 4, P.F_FIN, 0)
             | torch.where((sel == 2) | (sel >= 3), P.F_ACK, 0))
    snd_max = _g(st, "sk_snd_max", sl)
    is_resend = (sel == 3) & (rex_pending | (snd_nxt < snd_max))
    pkt = P.make(state.shape[0], state.device, src=hp.hid,
                 dst=_g(st, "sk_rhost", sl), sport=_g(st, "sk_lport", sl),
                 dport=_g(st, "sk_rport", sl), flags=flags, seq=seq,
                 ack=ack_no, wnd=wnd, length=ln, aux=aux,
                 app=torch.where(sel == 1, _g(st, "sk_syn_tag", sl), sack2),
                 status=P.DS_CREATED | torch.where(is_resend, P.DS_RETRANS, 0))

    # clear the control bit served; any ACK-bearing send covers ACKNOW
    clr = torch.zeros_like(ctl)
    for code, bit in ((0, CTL_RST), (1, CTL_SYN), (2, CTL_SYNACK),
                      (4, CTL_FIN)):
        clr = torch.where(sel == code, bit, clr)
    clr = clr | torch.where((sel == 2) | (sel >= 3), CTL_ACKNOW, 0)
    _set(st, sl, m, sk_ctl=ctl & ~clr, sk_last_tx=now)

    # data accounting: fresh transmission vs retransmission, RTT timing
    is_data = sel == 3
    is_rex = is_data & rex_pending
    new_nxt = snd_nxt + ln.to(_I64)
    advance = is_data & ~is_rex & (new_nxt > snd_max)
    gbn = is_data & ~is_rex & (snd_nxt < snd_max)
    fresh_bytes = torch.where(advance,
                              new_nxt - torch.maximum(snd_max, snd_nxt), 0)
    col_add(st.stats, ST_BYTES_SENT, m, fresh_bytes)
    col_add(st.stats, ST_RETRANSMIT, m & (is_rex | gbn))
    # retransmit-interval distribution: the RTO in force at each
    # retransmission
    if netscope.on(st):
        netscope.observe(st, m & (is_rex | gbn), netscope.NS_RETX,
                         _g(st, "sk_rto", sl) // 1000)
    rtt_seq = _g(st, "sk_rtt_seq", sl)
    time_it = is_data & ~is_rex & ~gbn & (rtt_seq < 0)
    _set(st, sl, m,
         sk_snd_nxt=torch.where(is_data & ~is_rex, new_nxt, snd_nxt),
         sk_rex_nxt=torch.where(is_rex, rex_nxt + ln.to(_I64), rex_nxt),
         sk_snd_max=torch.where(advance, new_nxt, snd_max),
         sk_rtt_seq=torch.where(time_it, new_nxt, rtt_seq),
         sk_rtt_time=torch.where(time_it, now, _g(st, "sk_rtt_time", sl)))

    # FIN send: EST -> FIN_WAIT_1, CLOSE_WAIT -> LAST_ACK
    is_fin = sel == 4
    st2 = torch.where(is_fin & (state == TCPS_ESTABLISHED), TCPS_FIN_WAIT_1,
                      torch.where(is_fin & (state == TCPS_CLOSE_WAIT),
                                  TCPS_LAST_ACK, state))
    _set(st, sl, m, sk_state=st2)
    sock_free(st, m & (sel == 0), sl)         # RST teardown after emit
    # arm the retransmission timer for anything that expects an answer
    _arm_timer(st, m & (hs | is_data | is_fin), sl, now)
    return pkt, has


# --- Receive path ----------------------------------------------------------

def _fdiv(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def _rfc6298(srtt, rttvar, sample):
    """RFC 6298 smoothed-RTT update -> (srtt', rttvar', rto')."""
    first = srtt < 0
    srtt1 = torch.where(first, sample, _fdiv(7 * srtt + sample, 8))
    rttvar1 = torch.where(first, _fdiv(sample, 2),
                          _fdiv(3 * rttvar + (srtt - sample).abs(), 4))
    rto = (srtt1 + (4 * rttvar1).clamp(min=1)).clamp(TCP_RTO_MIN, TCP_RTO_MAX)
    return srtt1, rttvar1, rto


def _autotune(st, hp, m, sl, pkt):
    """Buffer autotuning from a handshake segment: 1.25x the
    delay-bandwidth product of the path (the peer's bandwidth stamps
    in AUX, the one-way latency in us in SEQ), min-bounded; loopback
    pairs get 16 MiB; explicit per-host sizes win."""
    rtt_us = 2 * pkt[:, P.SEQ].to(_I64).clamp(min=0)
    peer_up = ((pkt[:, P.AUX] >> 16) & 0xFFFF).to(_I64) << 10
    peer_dn = (pkt[:, P.AUX] & 0xFFFF).to(_I64) << 10
    bw_cap = 1 << 38
    snd_bw = torch.minimum(hp.bw_up, peer_dn).clamp(max=bw_cap)
    rcv_bw = torch.minimum(hp.bw_down, peer_up).clamp(max=bw_cap)
    buf_cap = 1 << 30
    sndbuf = _fdiv(_fdiv(snd_bw * rtt_us, 1_000_000) * 5, 4).clamp(
        SEND_BUFFER_MIN_SIZE, buf_cap)
    rcvbuf = _fdiv(_fdiv(rcv_bw * rtt_us, 1_000_000) * 5, 4).clamp(
        RECV_BUFFER_MIN_SIZE, buf_cap)
    is_loop = pkt[:, P.SRC] == hp.hid
    sndbuf = torch.where(is_loop, 16 * 1024 * 1024, sndbuf)
    rcvbuf = torch.where(is_loop, 16 * 1024 * 1024, rcvbuf)
    _set(st, sl, m,
         sk_sndbuf=torch.where(hp.sndbuf0 >= 0, hp.sndbuf0, sndbuf),
         sk_rcvbuf=torch.where(hp.rcvbuf0 >= 0, hp.rcvbuf0, rcvbuf))


def _accept_syn(st, hp, sh, m, now, lslot, pkt):
    """Listener got a SYN: a child row in SYN_RECEIVED owing SYN|ACK."""
    child, ok = sock_alloc(st, m, P.PROTO_TCP)
    ch, lsl = _sl(st, child), _sl(st, lslot)
    w = m & ok
    _set(st, ch, w, sk_state=TCPS_SYN_RECEIVED,
         sk_lport=pkt[:, P.DPORT], sk_rport=pkt[:, P.SPORT],
         sk_rhost=pkt[:, P.SRC], sk_parent=lsl.idx,
         # children inherit the listener's owning process
         sk_proc=_g(st, "sk_proc", lsl), sk_ctl=CTL_SYNACK,
         sk_cwnd=sh.tcp_init_wnd, sk_ssthresh=sh.tcp_ssthresh0,
         sk_peer_rwnd=pkt[:, P.WND].to(_I64).clamp(min=1),
         sk_hs_time=now, sk_syn_tag=pkt[:, P.APP])
    _autotune(st, hp, w, ch, pkt)
    _arm_timer(st, w, ch, now)
    col_add(st.stats, ST_SOCK_FAIL, m & ~ok)


def _rx_conn(st, hp, sh, m, now, slot, pkt, parts):
    """Segment processing for a non-listening socket: establishment,
    ACK processing with SACK and congestion control, data with the
    out-of-order scoreboard, peer FIN, TIME_WAIT/close bookkeeping.

    `parts` (a set of "data", "fin", "finack", "sack") names the
    sub-branches some masked row can take; the caller derives it from
    the packet words, and a branch no row can take is skipped (its
    every write would be a no-op)."""
    run = parts.__contains__
    sl = _sl(st, slot)
    flags = pkt[:, P.FLAGS]
    syn = (flags & P.F_SYN) != 0
    ackf = (flags & P.F_ACK) != 0
    fin = (flags & P.F_FIN) != 0
    seq = pkt[:, P.SEQ].to(_I64)
    ackno = pkt[:, P.ACK].to(_I64)
    ln = pkt[:, P.LEN].to(_I64)
    finack = ~syn & ((pkt[:, P.AUX] & AUX_FINACK) != 0)
    state0 = _g(st, "sk_state", sl)

    # --- A. establishment ---
    estA = (state0 == TCPS_SYN_SENT) & syn & ackf
    estB = (state0 == TCPS_SYN_RECEIVED) & ackf & ~syn
    resyn = (state0 == TCPS_SYN_RECEIVED) & syn & ~ackf
    resynack = (state0 >= TCPS_ESTABLISHED) & syn & ackf
    est = estA | estB
    state1 = torch.where(est, TCPS_ESTABLISHED, state0)
    hs_rtt = now - _g(st, "sk_hs_time", sl)
    srtt0 = _g(st, "sk_srtt", sl)
    hs_srtt, hs_rttvar, hs_rto = _rfc6298(srtt0, _g(st, "sk_rttvar", sl),
                                          hs_rtt)
    rtt_min0 = _g(st, "sk_rtt_min", sl)
    _set(st, sl, m,
         sk_state=state1,
         sk_ctl=(_g(st, "sk_ctl", sl) | torch.where(estA, CTL_ACKNOW, 0)
                 | torch.where(resyn, CTL_SYNACK, 0)
                 | torch.where(resynack, CTL_ACKNOW, 0)),
         sk_srtt=torch.where(est, hs_srtt, srtt0),
         sk_rtt_min=torch.where(
             est, torch.where(rtt_min0 > 0, torch.minimum(rtt_min0, hs_rtt),
                              hs_rtt), rtt_min0),
         sk_rttvar=torch.where(est, hs_rttvar, _g(st, "sk_rttvar", sl)),
         sk_rto=torch.where(est, hs_rto, _g(st, "sk_rto", sl)),
         sk_rto_deadline=torch.where(est, 0,
                                     _g(st, "sk_rto_deadline", sl)))
    _wake(st, m & est, now, torch.where(estA, WAKE_CONNECTED, WAKE_ACCEPT),
          sl, pkt=pkt)
    # --- A2. the active opener tunes its buffers on the SYN|ACK ---
    _autotune(st, hp, m & estA, sl, pkt)

    # --- B. ACK processing ---
    conn = state1 >= TCPS_ESTABLISHED
    valid_ack = ackf & conn
    snd_una0 = _g(st, "sk_snd_una", sl)
    snd_end = _g(st, "sk_snd_end", sl)
    new_ack = valid_ack & (ackno > snd_una0)
    acked_bytes = (ackno - snd_una0).clamp(min=0)
    npkts = _fdiv(acked_bytes + TCP_MSS - 1, TCP_MSS)
    snd_una1 = torch.where(new_ack, ackno, snd_una0)

    # the peer's SACK blocks join the sender scoreboard; the cumulative
    # ack prunes it
    snd_max0 = _g(st, "sk_snd_max", sl)
    if run("sack"):
        upd = valid_ack & ~syn
        b1s, b1e = sack.decode(pkt[:, P.AUX], ackno, snd_max0)
        b2s, b2e = sack.decode(pkt[:, P.APP], ackno, snd_max0)
        sb_s, sb_e = sack.insert(_g(st, "sk_sack_s", sl),
                                 _g(st, "sk_sack_e", sl),
                                 torch.where(upd, b1s, -1),
                                 torch.where(upd, b1e, -2))
        sb_s, sb_e = sack.insert(sb_s, sb_e, torch.where(upd, b2s, -1),
                                 torch.where(upd, b2e, -2))
        sb_s, sb_e = sack.drop_below(sb_s, sb_e, snd_una1)
        _set(st, sl, m, sk_sack_s=sb_s, sk_sack_e=sb_e)

    # RTT sample (Karn: only the timed offset, cleared on retransmit)
    rtt_seq = _g(st, "sk_rtt_seq", sl)
    sample_ok = new_ack & (rtt_seq >= 0) & (ackno >= rtt_seq)
    rtt_sample = (now - _g(st, "sk_rtt_time", sl)).clamp(min=1)
    srtt = _g(st, "sk_srtt", sl)
    rttvar = _g(st, "sk_rttvar", sl)
    srtt1, rttvar1, rto1 = _rfc6298(srtt, rttvar, rtt_sample)
    rtt_min0 = _g(st, "sk_rtt_min", sl)
    rtt_min1 = torch.where(rtt_min0 > 0,
                           torch.minimum(rtt_min0, rtt_sample), rtt_sample)
    # congestion: avoidance on new acks, loss on the 3rd dupack
    dup = (valid_ack & (ackno == snd_una0) & (ln == 0) & ~syn & ~fin &
           (_g(st, "sk_snd_nxt", sl) > snd_una0))
    dupacks1 = torch.where(new_ack, 0, _g(st, "sk_dupacks", sl)
                           + dup.to(_I32))
    fast_rx = dup & (dupacks1 == 3)

    cw0, ss0 = _g(st, "sk_cwnd", sl), _g(st, "sk_ssthresh", sl)
    wm0, ep0 = _g(st, "sk_cc_wmax", sl), _g(st, "sk_cc_epoch", sl)
    k0 = _g(st, "sk_cc_k", sl)
    delay_ns = torch.where(rtt_min0 > 0, rtt_min0, srtt)
    cw_a, ep_a, k_a = CC.on_ack(sh.cc_kind, cw0, ss0, wm0, ep0, k0, npkts,
                                now, delay_ns, live=m & new_ack & ~fast_rx)
    cw_l, ss_l, wm_l, ep_l = CC.on_loss(sh.cc_kind, cw0, ss0, wm0)
    hole_end0 = _g(st, "sk_hole_end", sl)
    rex_nxt0 = _g(st, "sk_rex_nxt", sl)
    _set(st, sl, m,
         sk_snd_una=snd_una1,
         sk_dupacks=dupacks1,
         sk_peer_rwnd=torch.where(valid_ack,
                                  pkt[:, P.WND].to(_I64).clamp(min=1),
                                  _g(st, "sk_peer_rwnd", sl)),
         sk_srtt=torch.where(sample_ok, srtt1, srtt),
         sk_rtt_min=torch.where(sample_ok, rtt_min1, rtt_min0),
         sk_rttvar=torch.where(sample_ok, rttvar1, rttvar),
         sk_rto=torch.where(sample_ok, rto1, _g(st, "sk_rto", sl)),
         sk_rtt_seq=torch.where(sample_ok, -1, rtt_seq),
         sk_cwnd=torch.where(fast_rx, cw_l, torch.where(new_ack, cw_a, cw0)),
         sk_ssthresh=torch.where(fast_rx, ss_l, ss0),
         sk_cc_wmax=torch.where(fast_rx, wm_l, wm0),
         sk_cc_epoch=torch.where(fast_rx, ep_l,
                                 torch.where(new_ack, ep_a, ep0)),
         sk_cc_k=torch.where(new_ack & ~fast_rx, k_a, k0),
         # recovery: resend every un-sacked hole below the recovery
         # point on its own cursor; a full ack of it ends the episode
         sk_hole_end=torch.where(
             fast_rx, snd_max0,
             torch.where(new_ack & (ackno >= hole_end0), 0, hole_end0)),
         sk_rex_nxt=torch.where(
             fast_rx, ackno,
             torch.where(new_ack, torch.maximum(rex_nxt0, ackno), rex_nxt0)))

    # our FIN acked?
    fin_done = valid_ack & finack & (ackno >= snd_end)
    fin_acked1 = _g(st, "sk_fin_acked", sl) | fin_done
    state2 = torch.where(
        fin_acked1 & (state1 == TCPS_FIN_WAIT_1), TCPS_FIN_WAIT_2,
        torch.where(fin_acked1 & (state1 == TCPS_CLOSING), TCPS_TIME_WAIT,
                    torch.where(fin_acked1 & (state1 == TCPS_LAST_ACK),
                                TCPS_CLOSED, state1)))
    _set(st, sl, m, sk_fin_acked=fin_acked1, sk_state=state2)

    # restart/stop the retransmission timer on forward progress
    flight = ((_g(st, "sk_snd_nxt", sl) > snd_una1) |
              (_fin_wait_states(state2) & ~fin_acked1))
    _set(st, sl, m & valid_ack, sk_rto_deadline=torch.where(
        flight, now + _g(st, "sk_rto", sl), 0))

    # all-written-bytes-acked notification
    sent_all = new_ack & (ackno >= snd_end) & (snd_end > 0)
    _wake(st, m & sent_all, now, WAKE_SENT, sl, pkt=pkt)

    # --- C. data: in-order delivery through the receive scoreboard ---
    rcv0 = _g(st, "sk_rcv_nxt", sl)
    rcv1 = rcv0
    if run("data"):
        can_rx = ((state2 == TCPS_ESTABLISHED) | (state2 == TCPS_FIN_WAIT_1)
                  | (state2 == TCPS_FIN_WAIT_2))
        has_data = (ln > 0) & can_rx
        seg_end = seq + ln
        in_order = has_data & (seq <= rcv0) & (seg_end > rcv0)
        adv = torch.where(in_order, seg_end, rcv0)
        oos1, ooe1, rcv1 = sack.consume(_g(st, "sk_ooo_s", sl),
                                        _g(st, "sk_ooo_e", sl), adv)
        is_ooo = has_data & (seq > rcv1)
        oos2, ooe2, reneged = sack.insert_counted(
            oos1, ooe1, torch.where(is_ooo, seq, -1),
            torch.where(is_ooo, seg_end, -2))
        delivered = rcv1 - rcv0
        _set(st, sl, m, sk_rcv_nxt=rcv1, sk_ooo_s=oos2, sk_ooo_e=ooe2)
        col_add(st.stats, ST_BYTES_RECV, m, delivered)
        col_add(st.stats, ST_SACK_RENEGE, m, reneged.to(_I64))
        _wake(st, m & (delivered > 0), now, WAKE_SOCKET, sl, pkt=pkt,
              ln=delivered.to(_I32), aux=pkt[:, P.AUX])
    _set(st, sl, m & ((ln > 0) | fin),
         sk_ctl=_g(st, "sk_ctl", sl) | CTL_ACKNOW)

    # --- D. peer FIN: recorded once, completion re-checked every segment
    state3 = state2
    if run("fin"):
        pf0 = _g(st, "sk_peer_fin", sl)
        fin_valid = fin & (state2 >= TCPS_ESTABLISHED)
        peer_fin1 = torch.where(fin_valid & (pf0 < 0), seq, pf0)
        fin_complete = (peer_fin1 >= 0) & (rcv1 >= peer_fin1)
        eof_now = fin_complete & ((state2 == TCPS_ESTABLISHED) |
                                  (state2 == TCPS_FIN_WAIT_1) |
                                  (state2 == TCPS_FIN_WAIT_2))
        state3 = torch.where(
            eof_now & (state2 == TCPS_ESTABLISHED), TCPS_CLOSE_WAIT,
            torch.where(eof_now & (state2 == TCPS_FIN_WAIT_1),
                        torch.where(fin_acked1, TCPS_TIME_WAIT, TCPS_CLOSING),
                        torch.where(eof_now & (state2 == TCPS_FIN_WAIT_2),
                                    TCPS_TIME_WAIT, state2)))
        _set(st, sl, m, sk_peer_fin=peer_fin1, sk_state=state3)
        _wake(st, m & eof_now, now, WAKE_EOF, sl, pkt=pkt)

    # --- E. terminal bookkeeping ---
    if run("fin") or run("finack"):
        tw = m & (state3 == TCPS_TIME_WAIT) & (state0 != TCPS_TIME_WAIT)
        equeue.q_push(st, tw, now + TCP_CLOSE_TIMER_DELAY, EV_TCP_CLOSE,
                      _timer_ev(sl.idx, _g(st, "sk_timer_gen", sl)))
        _stop_timer(st, tw, sl)
        sock_free(st, m & (state3 == TCPS_CLOSED), sl)


def rx_parts(pkt):
    """[H] masks of the _rx_conn sub-branches a segment can reach,
    from its words alone: data (LEN > 0), the peer-FIN check (FIN or
    data: data can fill the hole below a recorded FIN), the close
    bookkeeping (also a FINACK: our FIN acked), and the sender
    scoreboard (SACK blocks on a non-SYN ACK)."""
    flags = pkt[:, P.FLAGS]
    syn = (flags & P.F_SYN) != 0
    data = pkt[:, P.LEN] > 0
    fin = ((flags & P.F_FIN) != 0) | data
    finack = ~syn & ((pkt[:, P.AUX] & AUX_FINACK) != 0)
    blocks = ~syn & ((((pkt[:, P.AUX] >> 16) & 0x7FFF) != 0) |
                     (((pkt[:, P.APP] >> 16) & 0x7FFF) != 0))
    return {"data": data, "fin": fin, "finack": finack, "sack": blocks}


def tcp_rx(st, hp, sh, m, now, slot, pkt, parts):
    """Inbound TCP segment for each masked row's socket `slot`: RST
    teardown, listener SYN -> child, else the connection machine; then
    kick the NIC. `parts` is the set of code names ("rst", "accept",
    "conn", and _rx_conn's parts) some masked row needs; the others
    are skipped."""
    run = parts.__contains__
    flags = pkt[:, P.FLAGS]
    syn = (flags & P.F_SYN) != 0
    ackf = (flags & P.F_ACK) != 0
    rst = (flags & P.F_RST) != 0
    sl = _sl(st, slot)
    state = _g(st, "sk_state", sl)
    if run("rst"):
        mr = m & rst
        _wake(st, mr & (state >= TCPS_ESTABLISHED), now, WAKE_EOF, sl,
              pkt=pkt)
        sock_free(st, mr, sl)
    listen_syn = (state == TCPS_LISTEN) & syn & ~ackf
    if run("accept"):
        _accept_syn(st, hp, sh, m & ~rst & listen_syn, now, sl, pkt)
    if run("conn"):
        _rx_conn(st, hp, sh, m & ~rst & ~listen_syn, now, sl, pkt, parts)
    nic.kick(st, m, now)


# --- Timers ----------------------------------------------------------------

def on_tcp_timer(st, hp, sh, m, now, wend, ev, expired):
    """EV_TCP_TIMER: RFC 6298 retransmission timeout with deadline
    re-chaining (one outstanding event per socket). `expired` False
    skips the timeout branch (the caller knows no row is due)."""
    sl = _sl(st, ev[:, P.SEQ])
    gen = ev[:, P.ACK]
    valid = (_g(st, "sk_used", sl) & (gen == _g(st, "sk_timer_gen", sl))
             & (_g(st, "sk_proto", sl) == P.PROTO_TCP))
    mv = m & valid
    deadline = _g(st, "sk_rto_deadline", sl)
    _set(st, sl, mv & (deadline == 0), sk_timer_on=False)
    equeue.q_push(st, mv & (deadline != 0) & (now < deadline), deadline,
                  EV_TCP_TIMER, _timer_ev(sl.idx, gen))
    if not expired:
        return

    mx = mv & (deadline != 0) & (now >= deadline)
    state = _g(st, "sk_state", sl)
    rto2 = (_g(st, "sk_rto", sl) * 2).clamp(max=TCP_RTO_MAX)
    ctl2 = (_g(st, "sk_ctl", sl)
            | torch.where(state == TCPS_SYN_SENT, CTL_SYN, 0)
            | torch.where(state == TCPS_SYN_RECEIVED, CTL_SYNACK, 0)
            | torch.where(_fin_wait_states(state)
                          & ~_g(st, "sk_fin_acked", sl), CTL_FIN, 0))
    snd_nxt = _g(st, "sk_snd_nxt", sl)
    snd_una = _g(st, "sk_snd_una", sl)
    had_flight = snd_nxt > snd_una
    cw, ss, wm = (_g(st, "sk_cwnd", sl), _g(st, "sk_ssthresh", sl),
                  _g(st, "sk_cc_wmax", sl))
    cw_l, ss_l, wm_l, ep_l = CC.on_loss(sh.cc_kind, cw, ss, wm)
    empty = torch.full((gen.shape[0], sack.K), -1, dtype=_I64,
                       device=gen.device)
    _set(st, sl, mx,
         sk_rto=rto2, sk_ctl=ctl2,
         sk_snd_nxt=torch.where(had_flight, snd_una, snd_nxt),   # go-back-N
         sk_cwnd=torch.where(had_flight, cw_l, cw),
         sk_ssthresh=torch.where(had_flight, ss_l, ss),
         sk_cc_wmax=torch.where(had_flight, wm_l, wm),
         sk_cc_epoch=torch.where(had_flight, ep_l,
                                 _g(st, "sk_cc_epoch", sl)),
         sk_hole_end=0,
         # after a timeout the peer may have reneged: trust no SACK
         sk_sack_s=empty, sk_sack_e=empty,
         sk_rtt_seq=-1,                                        # Karn
         sk_timer_on=False)
    _arm_timer(st, mx, sl, now)
    nic.kick(st, mx, now)


def on_tcp_close(st, hp, sh, m, now, wend, ev):
    """EV_TCP_CLOSE: TIME_WAIT expiry frees the socket row."""
    sl = _sl(st, ev[:, P.SEQ])
    gen = ev[:, P.ACK]
    valid = (_g(st, "sk_used", sl) & (gen == _g(st, "sk_timer_gen", sl))
             & (_g(st, "sk_state", sl) == TCPS_TIME_WAIT))
    sock_free(st, m & valid, sl)
