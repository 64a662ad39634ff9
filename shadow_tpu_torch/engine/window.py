"""The conservative-lookahead window loop.

Counterpart of ``shadow_tpu/engine/window.py``. Each window does:

1. **drain** — every host pops and executes its earliest event below the
   window end, one lockstep pass at a time (``step_all_hosts``), until
   no host has an event below it. A pass runs each event kind's
   handler on exactly the rows holding that kind (a ``[H]`` mask per
   kind, so every row's result is what its own branch gives), then
   chains a due-now NIC-TX, as the reference's ``step_one_host`` does.
   Under the CPU model (``cfg.cpu_model``) an event whose host CPU is
   busy past its threshold is pushed back to when the CPU drains, each
   event that runs charges its cost to the CPU, and no NIC-TX is
   chained.
2. **cap_peaks** — peak occupancy of the fixed-capacity arrays.
3. **exchange** — route the outboxes, roll for loss, stable-sort by
   destination, merge into the destination queues, carry the rest;
   with ``cfg.tracecap`` the departures and arrivals of hosts with
   ``logpcap`` go into their packet-trace rings (obs.pcap).
4. **advance** — the next window opens at the global minimum next event
   (or carried arrival), with the reference's anti-livelock rule.

The reference runs this as one compiled ``while_loop``; here it is a
Python loop with host syncs: one per drain pass (``_pass_flags``: the
loop condition and which handler branches have rows) plus one for the
due-now NIC-TX chain, and a few per window. Moving the loop onto the
device (a CUDA graph or a device-side loop) is ROADMAP B3.

Not ported, because the reference holds them bit-identical to the dense
drain and the single full sort: the compaction rung ladders, window
rungs, the hot/cold split, event batching and the compacted exchange
paths.
"""

from __future__ import annotations

import torch

from ..apps.base import (N_APP_KINDS, N_BRANCHES, branch_of, dispatch,
                         process_of)
from ..core import rng as R
from ..core.rowops import col_add, rget, set_where
from ..core.simtime import SIMTIME_MAX
from ..net import nic
from ..net import packet as P
from ..net import tcp
from ..net.socket import sock_demux
from ..net.udp import udp_deliver
from ..obs.passcope import scope
from . import equeue
from .defs import (EV_APP, EV_NIC_TX, EV_NULL, EV_PKT, EV_TCP_CLOSE,
                   EV_TCP_TIMER, N_EVENT_KINDS, ST_DEFER_A2A,
                   ST_DEFER_FANIN, ST_EVENTS, ST_PKTS_DROP_NET,
                   ST_PKTS_DROP_Q, ST_PKTS_RECV)
from .state import EngineConfig

# pass-flag codes: an event kind, or (for EV_APP) one per (app, branch)
_N_CODES = N_EVENT_KINDS + N_BRANCHES * N_APP_KINDS

# TCP pass-flag parts (uses_tcp configs): which TCP sub-branches some
# row of the pass can take, so that the others launch nothing. Read off
# the popped event's words, plus two cheap state reads ("sack": a
# non-empty sender scoreboard to prune; "rto": the timer is due).
_TCP_PARTS = ("udp", "rst", "accept", "conn", "data", "fin", "finack",
              "sack", "pull", "rto")


def _app_code(app_kind, branch):
    return N_EVENT_KINDS + N_BRANCHES * app_kind + branch


# --- Event handlers --------------------------------------------------------

def _on_pkt(st, hp, sh, m, now, pkt, cfg: EngineConfig, parts):
    """Packet arrival at the NIC: admission, demux, TCP or UDP."""
    with scope("nic.rx_admit"):
        keep = nic.rx_admit(st, hp, m, now, pkt)
    md = m & keep
    col_add(st.stats, ST_PKTS_RECV, md)
    pkt_in = pkt.clone()
    pkt_in[:, P.STATUS] |= P.DS_RX_BUFFERED
    mu = md
    if cfg.uses_tcp:
        is_tcp = (pkt[:, P.FLAGS] & P.PROTO_MASK) == P.PROTO_TCP
        mu = md & ~is_tcp
        if parts & {"rst", "accept", "conn"}:
            with scope("tcp.rx"):
                slot = sock_demux(st, pkt[:, P.SRC], pkt[:, P.SPORT],
                                  pkt[:, P.DPORT], P.PROTO_TCP)
                tcp.tcp_rx(st, hp, sh, md & is_tcp & (slot >= 0), now,
                           slot, pkt_in, parts)
        if "udp" not in parts:
            return
    with scope("udp.deliver"):
        slot = sock_demux(st, pkt[:, P.SRC], pkt[:, P.SPORT],
                          pkt[:, P.DPORT], P.PROTO_UDP)
        udp_deliver(st, hp, sh, mu & (slot >= 0), now, slot, pkt_in)


def _tcp_features(st, kind, pkt, t):
    """[len(_TCP_PARTS), H] bool: the rows that can take each part."""
    flags = pkt[:, P.FLAGS]
    on_pkt = kind == EV_PKT
    is_tcp = on_pkt & ((flags & P.PROTO_MASK) == P.PROTO_TCP)
    syn = (flags & P.F_SYN) != 0
    rst = (flags & P.F_RST) != 0
    conn = is_tcp & ~rst
    sub = tcp.rx_parts(pkt)
    sboard = (st.sk_sack_s[:, :, 0] >= 0).any(1)
    deadline = rget(st.sk_rto_deadline, pkt[:, P.SEQ])
    return torch.stack([
        on_pkt & ~is_tcp,
        is_tcp & rst,
        conn & syn & ((flags & P.F_ACK) == 0),
        conn,
        conn & sub["data"],
        conn & sub["fin"],
        conn & sub["finack"],
        conn & (sub["sack"] | sboard),
        (kind == EV_NIC_TX) & (st.txq_cnt == 0)
        & (st.ob_cnt < st.ob_time.shape[1]),
        (kind == EV_TCP_TIMER) & (deadline != 0) & (t >= deadline),
    ])


def _pass_flags(st, kind, app_kind, branch, pkt, t, cfg: EngineConfig,
                blocked=None):
    """Which codes at least one row holds this pass -> (set of codes,
    set of TCP parts; empty when the config has no TCP; whether any row
    is CPU-blocked, under the CPU model; whether a hosted wake ring is
    near full, with hosted apps). The one host sync of the pass (rows
    with no ready event hold EV_NULL)."""
    code = torch.where(kind == EV_APP, _app_code(app_kind, branch), kind)
    present = torch.zeros(_N_CODES, dtype=torch.int32, device=kind.device)
    present.scatter_(0, code.to(torch.int64), 1)
    extra = []
    if cfg.uses_tcp:
        extra.append(_tcp_features(st, kind, pkt, t).any(1))
    if blocked is not None:
        extra.append(blocked.any()[None])
    if cfg.hostedcap > 1:
        # the hosted pause: stop before any wake ring can overflow, so
        # the CPU tier drains it (the window re-opens after the step);
        # the floor keeps tiny rings from wedging the loop
        cap = max(st.hw_time.shape[1] - 4, 1)
        extra.append((st.hw_cnt.max() >= cap)[None])
    if extra:
        present = torch.cat([present] + [e.to(torch.int32) for e in extra])
    vals = present.tolist()
    codes = {i for i, v in enumerate(vals[:_N_CODES]) if v}
    parts = {n for n, v in zip(_TCP_PARTS, vals[_N_CODES:]) if v}
    rest = vals[_N_CODES + (len(_TCP_PARTS) if cfg.uses_tcp else 0):]
    any_blocked = blocked is not None and bool(rest.pop(0))
    paused = cfg.hostedcap > 1 and bool(rest.pop(0))
    return codes, parts, any_blocked, paused


def step_all_hosts(st, hp, sh, wend, cfg: EngineConfig,
                   lane_passes=None) -> bool:
    """One lockstep pass: every host whose earliest event lies below
    `wend` pops and runs it. Returns False, changing nothing, when no
    host has one, or when a hosted wake ring is near full.

    `wend` is an int, or a [rows] tensor holding each row's own window
    end (stacked lanes); `lane_passes` ([B] int64), when given, counts
    the passes in which each lane had a row to step."""
    slot, t = equeue.q_min(st)
    ready = t < wend
    stepped = ready
    kind = torch.where(ready, rget(st.eq_kind, slot), EV_NULL)
    pkt = rget(st.eq_pkt, slot)
    # the app kind of each wake's process: with one process per host the
    # [:, 0] view (no launch), else the process the wake belongs to
    proc = None
    app_kind = hp.app_kind[:, 0]
    if cfg.procs_per_host > 1:
        proc = process_of(st, pkt)
        app_kind = rget(hp.app_kind, proc)
    blocked = None
    if cfg.cpu_model:
        # the reference's CPU model: an event whose host CPU is busy
        # past the threshold is pushed to when the CPU drains
        blocked = (ready & (hp.cpu_threshold >= 0)
                   & (st.cpu_avail - t > hp.cpu_threshold))
        ready = ready & ~blocked
        pop_kind, kind = kind, torch.where(blocked, EV_NULL, kind)
    flags, parts, any_blocked, paused = _pass_flags(
        st, kind, app_kind, branch_of(pkt), pkt, t, cfg, blocked)
    flags.discard(EV_NULL)
    if paused or (not flags and not any_blocked):
        return False
    if lane_passes is not None:
        lane_passes += stepped.view(lane_passes.shape[0], -1).any(1)

    if any_blocked:
        equeue.q_clear_slot(st, blocked, slot)
        equeue.q_push(st, blocked, torch.maximum(st.cpu_avail, t + 1),
                      pop_kind, pkt)
    equeue.q_clear_slot(st, ready, slot)
    apps = {((c - N_EVENT_KINDS) // N_BRANCHES,
             (c - N_EVENT_KINDS) % N_BRANCHES)
            for c in flags if c >= N_EVENT_KINDS}
    if apps:
        dispatch(st, hp, sh, kind == EV_APP, t, pkt, apps, proc)
    if EV_PKT in flags:
        _on_pkt(st, hp, sh, kind == EV_PKT, t, pkt, cfg, parts)
    if EV_NIC_TX in flags:
        with scope("nic.tx"):
            nic.on_tx(st, hp, sh, kind == EV_NIC_TX, t, wend, cfg.qdisc,
                      tcp=cfg.uses_tcp, pull_tcp="pull" in parts)
    if cfg.uses_tcp and EV_TCP_TIMER in flags:
        with scope("tcp.timer"):
            tcp.on_tcp_timer(st, hp, sh, kind == EV_TCP_TIMER, t, wend,
                             pkt, expired="rto" in parts)
    if cfg.uses_tcp and EV_TCP_CLOSE in flags:
        tcp.on_tcp_close(st, hp, sh, kind == EV_TCP_CLOSE, t, wend, pkt)

    if cfg.cpu_model:
        # every pop re-checks the CPU, so no NIC-TX is chained; the
        # event's cost is charged to the busy horizon
        set_where(st.cpu_avail, ready,
                  torch.maximum(st.cpu_avail, t) + hp.cpu_cost)
        st.stats[:, ST_EVENTS] += ready.to(torch.int64)
        return True

    # Chain a due-now NIC-TX into the same pass, as the reference does:
    # executing the queue head early is what the next pass would do.
    slot2, t2 = equeue.q_min(st)
    due = ready & (t2 == t) & (rget(st.eq_kind, slot2) == EV_NIC_TX)
    if cfg.uses_tcp:
        pull2 = due & (st.txq_cnt == 0) & (st.ob_cnt < st.ob_time.shape[1])
        any_due, pull = torch.stack([due.any(), pull2.any()]).tolist()
    else:
        any_due, pull = bool(due.any()), False     # host sync
    if any_due:
        equeue.q_clear_slot(st, due, slot2)
        with scope("nic.tx"):
            nic.on_tx(st, hp, sh, due, t, wend, cfg.qdisc,
                      tcp=cfg.uses_tcp, pull_tcp=pull)
    st.stats[:, ST_EVENTS] += ready.to(torch.int64) + due.to(torch.int64)
    return True


def drain_window(st, hp, sh, wend, cfg: EngineConfig,
                 lane_passes=None) -> int:
    """Execute every event below `wend` (an int, or each row's own);
    returns the pass count."""
    passes = 0
    while step_all_hosts(st, hp, sh, wend, cfg, lane_passes):
        passes += 1
    return passes


# --- Window-boundary packet exchange ----------------------------------------

def _intake_take(nfree, count_of, IN, cfg: EngineConfig):
    """Per-destination intake: min(count, IN, headroom), headroom being
    free queue slots less a reserve for protocol-internal pushes,
    floored at one arrival while at least two slots are free."""
    reserve = min(8, cfg.qcap // 4)
    floor = torch.where(nfree >= 2, 1, 0)
    allow = torch.clamp(torch.maximum(nfree - reserve, floor), max=IN)
    return torch.minimum(count_of, allow)


def _deliver_dense(nfree, order, sdst, pkts, arrival, IN,
                   cfg: EngineConfig, lo: int = 0):
    """Build the [H, IN] inbound buffers of rows [lo, lo + H) from the
    destination-sorted packet list (every destination's run is
    contiguous) and the accepted mask over the sorted list (False for
    entries destined outside the block). The single exchange passes the
    whole state (lo = 0); the sharded one (parallel.shard) one shard's
    row block of the gathered list."""
    N = sdst.shape[0]
    H = nfree.shape[0]
    dsts = torch.arange(lo, lo + H, dtype=sdst.dtype, device=sdst.device)
    first_of = torch.searchsorted(sdst, dsts, side="left")
    count_of = torch.searchsorted(sdst, dsts, side="right") - first_of
    take_of = _intake_take(nfree, count_of, IN, cfg)

    r = torch.arange(IN, device=sdst.device)
    j = (first_of[:, None] + r[None, :]).clamp(0, N - 1)
    oj = order[j]
    cell_ok = r[None, :] < take_of[:, None]
    in_time = torch.where(cell_ok, arrival[oj], SIMTIME_MAX)
    in_pkt = torch.where(cell_ok[:, :, None], pkts[oj], 0)

    db = sdst - lo if lo else sdst
    inblock = (db >= 0) & (db < H)
    dbc = db.clamp(0, H - 1)
    rank = torch.arange(N, device=sdst.device) - first_of[dbc]
    kept_sorted = inblock & (rank < take_of[dbc])
    return in_pkt, in_time, kept_sorted


def _carry_outbox(st, pkts, stimes, arrival, stay, O):
    """Compact the packets in `stay` to the front of each source outbox
    (original order kept); record the earliest carried arrival."""
    H = st.ob_cnt.shape[0]
    stay2 = stay.view(H, O)
    ordr = torch.argsort((~stay2).to(torch.int32), dim=1, stable=True)
    st.ob_pkt.copy_(pkts.view(H, O, -1).gather(
        1, ordr[:, :, None].expand(H, O, P.PKT_WORDS)))
    st.ob_time.copy_(stimes.view(H, O).gather(1, ordr))
    st.ob_cnt.copy_(stay2.sum(1))
    st.ob_next.copy_(torch.where(stay2, arrival.view(H, O),
                                 SIMTIME_MAX).min(1).values)


def _trace_append(st, pkts, times, valid, dirv: int, on):
    """Append the records of each row's valid slots ([H, n] `times` and
    `valid`, [H, n, W] `pkts`), in slot order, to the packet-trace ring
    (obs.pcap) of every row where `on` holds: the rank is a cumsum over
    the row's valid slots, writes at positions >= TC are dropped,
    ``tr_cnt`` saturates at TC and the overflow is added to
    ``tr_drop``."""
    H, TC = st.tr_time.shape
    take = valid & on[:, None]
    k = take.sum(1, dtype=torch.int32)
    pos = st.tr_cnt[:, None] + torch.cumsum(take, 1, dtype=torch.int32) - 1
    # rows write into one extra column, which takes the dropped records
    tgt = torch.where(take & (pos < TC), pos, TC).to(torch.int64)

    def put(ring, vals):
        ext = torch.cat([ring, ring[:, :1]], 1)
        idx = tgt.view(tgt.shape + (1,) * (ring.dim() - 2)).expand(
            tgt.shape + ring.shape[2:])
        ext.scatter_(1, idx, vals.to(ring.dtype))
        ring.copy_(ext[:, :TC])

    put(st.tr_time, times)
    put(st.tr_pkt, pkts)
    put(st.tr_dir, torch.full_like(tgt, dirv))
    st.tr_drop += (st.tr_cnt + k - TC).clamp(min=0)
    st.tr_cnt.copy_((st.tr_cnt + k).clamp(max=TC))


def merge_arrivals(st, in_pkt, in_time, hp=None, cfg: EngineConfig = None):
    """Merge each host's inbound arrivals into its queue free slots
    (eq_seq = eq_ctr + free-rank), after their rx records go to the
    trace ring when `cfg` traces. The intake already fits the
    headroom, so ST_PKTS_DROP_Q counts only an engine bug."""
    if cfg is not None and cfg.tracecap:
        _trace_append(st, in_pkt, in_time, in_time != SIMTIME_MAX, 0,
                      hp.pcap_on)
    IN = in_time.shape[1]
    k = (in_time != SIMTIME_MAX).sum(1)
    free = st.eq_time == SIMTIME_MAX
    k2 = torch.minimum(k, free.sum(1))
    frank = torch.cumsum(free, 1) - 1
    take = free & (frank < k2[:, None])
    j = frank.clamp(0, IN - 1)
    st.eq_time.copy_(torch.where(take, in_time.gather(1, j), st.eq_time))
    st.eq_kind.copy_(torch.where(take, EV_PKT, st.eq_kind))
    st.eq_seq.copy_(torch.where(take, st.eq_ctr[:, None] + frank, st.eq_seq))
    st.eq_pkt.copy_(torch.where(take[:, :, None], in_pkt.gather(
        1, j[:, :, None].expand(-1, -1, P.PKT_WORDS)), st.eq_pkt))
    st.eq_ctr += k2.to(torch.int32)
    st.eq_next.copy_(st.eq_time.min(1).values)
    st.stats[:, ST_PKTS_DROP_Q] += k - k2


def route(st, sh, seed: int, H: int):
    """The exchange's source side: every outbox slot's routing, the
    handshake latency stamp and the loss roll, keyed by the globally
    unique (src, uid) of the packet, so a slot's fate does not depend on
    where its row lies (`H` is the global host count; the sharded
    exchange routes each shard's rows with it). -> (pkts, stimes,
    arrival, valid, deliver, dst) over the [rows * O] slots."""
    rows, O = st.ob_time.shape
    N = rows * O

    pkts = st.ob_pkt.reshape(N, P.PKT_WORDS).clone()
    stimes = st.ob_time.reshape(N)
    ar_o = torch.arange(O, device=stimes.device)
    valid = (ar_o[None, :] < st.ob_cnt[:, None]).reshape(N)

    src = pkts[:, P.SRC].clamp(0, H - 1).to(torch.int64)
    dst = pkts[:, P.DST].clamp(0, H - 1).to(torch.int64)
    sv = sh.host_vertex[src].to(torch.int64)
    dv = sh.host_vertex[dst].to(torch.int64)
    lat = sh.lat_ns[sv, dv]
    rel = sh.rel[sv, dv]
    arrival = stimes + lat
    # handshake segments carry the one-way path latency (us) in SEQ
    is_syn = (pkts[:, P.FLAGS] & P.F_SYN) != 0
    pkts[:, P.SEQ] = torch.where(is_syn, (lat // 1000).to(torch.int32),
                                 pkts[:, P.SEQ])

    u = R.cheap_uniform(R.stream_of(seed, R.DOMAIN_DROP, src),
                        pkts[:, P.UID])
    deliver = valid & (rel > 0) & (u <= rel)
    return pkts, stimes, arrival, valid, deliver, dst


def exchange(st, hp, sh, cfg: EngineConfig, seed: int):
    """Route, loss-roll and deliver all outbox packets into destination
    event queues; carry what the destinations cannot take this window
    (arrival stamps unchanged — exact deferral, never a drop)."""
    H = st.ob_time.shape[0]
    pkts, stimes, arrival, valid, deliver, dst = route(st, sh, seed, H)
    _deliver_and_carry(st, hp, cfg, pkts, stimes, arrival, valid,
                       deliver, torch.where(deliver, dst, H))


def _deliver_and_carry(st, hp, cfg: EngineConfig, pkts, stimes, arrival,
                       valid, deliver, sortkey, frozen=None):
    """The exchange after routing: stable-sort the delivered packets by
    destination row (`sortkey`; undelivered ones sort last), take each
    destination's intake, count the losses and deferrals, carry the
    rest (and the `frozen` slots, untouched) and merge the arrivals."""
    net_dropped = valid & ~deliver
    order = torch.argsort(sortkey, stable=True)
    sdst = sortkey[order]
    nfree = (st.eq_time == SIMTIME_MAX).sum(1)
    in_pkt, in_time, kept_sorted = _deliver_dense(
        nfree, order, sdst, pkts, arrival, cfg.incap, cfg)
    kept = torch.zeros(sortkey.shape[0], dtype=torch.bool,
                       device=pkts.device)
    kept[order] = kept_sorted
    settle(st, hp, cfg, pkts, stimes, arrival, deliver, net_dropped, kept,
           None, in_pkt, in_time, frozen)


def settle(st, hp, cfg: EngineConfig, pkts, stimes, arrival, deliver,
           net_dropped, accepted, shipped, in_pkt, in_time, frozen=None):
    """The exchange's tail, one implementation for the single, lane and
    sharded exchanges: the tx trace records of the packets departing
    this window (`accepted` by their destinations, or lost), the loss
    count, the deferral counts — a delivered packet not accepted defers
    in ST_DEFER_FANIN, or in ST_DEFER_A2A when `shipped` (the sharded
    exchange's bucket mask) says it never left its shard — the carry
    of the rest (and the `frozen` slots, untouched) and the merge of
    `in_pkt`/`in_time` into the queues."""
    rows, O = st.ob_time.shape
    if cfg.tracecap:
        # a carried packet is traced in the window it ships
        _trace_append(st, pkts.view(rows, O, -1), stimes.view(rows, O),
                      (accepted | net_dropped).view(rows, O), 1,
                      hp.pcap_on)
    stay = deliver & ~accepted
    st.stats[:, ST_PKTS_DROP_NET] += net_dropped.view(rows, O).sum(1)
    if shipped is None:
        st.stats[:, ST_DEFER_FANIN] += stay.view(rows, O).sum(1)
    else:
        st.stats[:, ST_DEFER_FANIN] += (stay & shipped).view(rows, O).sum(1)
        st.stats[:, ST_DEFER_A2A] += (stay & ~shipped).view(rows, O).sum(1)
    if frozen is not None:
        stay = stay | frozen
    _carry_outbox(st, pkts, stimes, arrival, stay, O)
    merge_arrivals(st, in_pkt, in_time, hp, cfg)


def exchange_lanes(st, hp, sh, cfg: EngineConfig, active):
    """``exchange`` over stacked lanes (``sh`` a LaneShared): each
    packet routes through its lane's tables, rolls loss with its lane's
    seed and lands at row lane*H + DST; a packet's words stay
    lane-local. The outbox of a lane that is not `active` ([B] bool)
    is left as it is, as jax's batched while_loop leaves a finished
    lane's carry."""
    B, H = sh.lanes, sh.hosts
    O = st.ob_time.shape[1]
    N = B * H * O
    dev = st.ob_time.device

    pkts = st.ob_pkt.reshape(N, P.PKT_WORDS).clone()
    stimes = st.ob_time.reshape(N)
    ar_o = torch.arange(O, device=dev)
    live = (ar_o[None, :] < st.ob_cnt[:, None]).reshape(N)
    on = active.repeat_interleave(H * O)
    valid = live & on

    lane = torch.arange(N, device=dev) // (H * O)
    row0 = lane * H
    src = pkts[:, P.SRC].clamp(0, H - 1).to(torch.int64)
    dst = pkts[:, P.DST].clamp(0, H - 1).to(torch.int64)
    sv = sh.host_vertex[row0 + src].to(torch.int64)
    dv = sh.host_vertex[row0 + dst].to(torch.int64)
    lat = sh.lat_ns[lane, sv, dv]
    rel = sh.rel[lane, sv, dv]
    arrival = stimes + lat
    is_syn = on & ((pkts[:, P.FLAGS] & P.F_SYN) != 0)
    pkts[:, P.SEQ] = torch.where(is_syn, (lat // 1000).to(torch.int32),
                                 pkts[:, P.SEQ])

    u = R.cheap_uniform(R.stream_from(sh.drop_base[lane], src),
                        pkts[:, P.UID])
    deliver = valid & (rel > 0) & (u <= rel)
    _deliver_and_carry(st, hp, cfg, pkts, stimes, arrival, valid,
                       deliver, torch.where(deliver, row0 + dst, B * H),
                       frozen=live & ~on)


def update_cap_peaks(st):
    """Peak occupancy of the event queue, socket table, outbox and NIC
    tx ring, sampled at window boundaries."""
    cur = torch.stack([(st.eq_time != SIMTIME_MAX).sum(1),
                       st.sk_used.sum(1), st.ob_cnt.to(torch.int64),
                       st.txq_cnt.to(torch.int64)], dim=1)
    st.cap_peaks.copy_(torch.maximum(st.cap_peaks, cur.to(torch.int32)))


# --- Multi-window driver ----------------------------------------------------

def next_event_time(st) -> int:
    """Global minimum pending event time (host sync)."""
    return int(st.eq_next.min())


def next_wakeup(st) -> int:
    """Earliest pending event or carried arrival (host sync)."""
    return int(torch.minimum(st.eq_next.min(), st.ob_next.min()))


@torch.inference_mode()
def run_windows(st, hp, sh, wstart: int, wend: int, cfg: EngineConfig,
                max_windows: int, clock=None):
    """Execute up to `max_windows` lookahead windows in place.

    Returns (wstart', wend', windows_run, passes). The caller loops
    until wstart' >= stop_time or wstart' == SIMTIME_MAX. `clock`, when
    given, is called with "drain", "exchange" and "advance" as each
    phase of a window ends (a wall-time split; chip_smoke --profile).
    Runs in inference mode: nothing here needs autograd, and skipping
    its bookkeeping shortens every operation's host time. Under an
    active passcope capture each phase is a labelled range."""
    tick = clock or (lambda _label: None)
    stop = int(sh.stop_time)
    min_jump = int(sh.min_jump)
    seed = int(sh.seed32)
    ws, we, i, passes = wstart, wend, 0, 0
    while i < max_windows and ws < stop and ws < SIMTIME_MAX:
        # never execute past the simulation end
        we_eff = min(we, stop)
        with scope("drain"):
            ran = next_event_time(st) < we_eff
            passes += drain_window(st, hp, sh, we_eff, cfg)
        tick("drain")
        with scope("cap_peaks"):
            update_cap_peaks(st)
        with scope("exchange"):
            ob0 = int(st.ob_cnt.sum())
            if ob0:     # an empty exchange is the identity
                exchange(st, hp, sh, cfg, seed)
        with scope("cap_peaks"):
            update_cap_peaks(st)
        tick("exchange")
        with scope("advance"):
            # anti-livelock: a window that executed nothing and shipped
            # nothing re-opens at the earliest queue event, not at the
            # same carried arrival
            progressed = ran or int(st.ob_cnt.sum()) < ob0
            nt = next_wakeup(st) if progressed else next_event_time(st)
            ws, we = nt, (SIMTIME_MAX if nt == SIMTIME_MAX
                          else nt + min_jump)
        tick("advance")
        i += 1
    return ws, we, i, passes


@torch.inference_mode()
def run_windows_batch(st, hp, sh, ws, we, cfg: EngineConfig,
                      max_windows: int, lane_passes):
    """``run_windows`` over B lanes stacked along the row axis (``sh`` a
    LaneShared; `ws`, `we` [B] int64 tensors, updated in place).

    Each lane runs up to `max_windows` windows of its own, exactly the
    windows its individual run would: a lane whose chunk or run has
    ended is frozen (its rows' window end is 0, so they pop nothing,
    and its outbox is left alone), as jax's batched while_loop freezes
    a finished lane. One drain pass steps every lane, and the advance
    takes each lane's values from one [B, H] reduction, so a window
    costs two host syncs whatever B is. `lane_passes` ([B] int64)
    counts each lane's passes. Returns (windows run [B] tensor, drain
    passes)."""
    B, H = sh.lanes, sh.hosts
    i = torch.zeros(B, dtype=torch.int64, device=ws.device)
    passes = 0
    while True:
        with scope("advance"):
            active = (i < max_windows) & (ws < sh.stop_time) \
                & (ws < SIMTIME_MAX)
            if not bool(active.any()):          # host sync
                break
            we_eff = torch.minimum(we, sh.stop_time)
            ran = st.eq_next.view(B, H).min(1).values < we_eff
            wend = torch.where(active, we_eff, 0).repeat_interleave(H)
        with scope("drain"):
            passes += drain_window(st, hp, sh, wend, cfg, lane_passes)
        with scope("cap_peaks"):
            update_cap_peaks(st)
        with scope("exchange"):
            ob0 = st.ob_cnt.view(B, H).sum(1) * active
            if bool(ob0.any()):                 # host sync
                exchange_lanes(st, hp, sh, cfg, active)
        with scope("cap_peaks"):
            update_cap_peaks(st)
        with scope("advance"):
            progressed = ran | (st.ob_cnt.view(B, H).sum(1) < ob0)
            nq = st.eq_next.view(B, H).min(1).values
            nt = torch.where(progressed, torch.minimum(
                nq, st.ob_next.view(B, H).min(1).values), nq)
            we2 = torch.where(nt == SIMTIME_MAX, SIMTIME_MAX,
                              nt + sh.min_jump)
            ws.copy_(torch.where(active, nt, ws))
            we.copy_(torch.where(active, we2, we))
            i += active
    return i, passes


# --- Determinism canonicalization -------------------------------------------

def canonicalize_state(arrs: dict) -> dict:
    """Zero dead slots in a host-side copy of the Hosts arrays so
    semantically identical states compare equal (the reference's
    canonicalize_state, wide layout): free event-queue slots, outbox
    tails past ob_cnt, NIC ring positions outside the live window,
    wake/trace ring tails, and unused socket rows."""
    import numpy as np

    a = dict(arrs)

    def scrub(key, dead):
        v = a[key]
        m = dead
        while m.ndim < v.ndim:
            m = m[..., None]
        a[key] = np.where(m, np.zeros((), v.dtype), v)

    free = a["eq_time"] == SIMTIME_MAX
    for k in ("eq_seq", "eq_kind", "eq_pkt"):
        scrub(k, free)
    O = a["ob_time"].shape[1]
    dead_ob = np.arange(O)[None, :] >= a["ob_cnt"][:, None]
    for k in ("ob_time", "ob_pkt"):
        scrub(k, dead_ob)
    T = a["txq_pkt"].shape[1]
    pos = (np.arange(T)[None, :] - a["txq_head"][:, None]) % T
    scrub("txq_pkt", pos >= a["txq_cnt"][:, None])
    HW = a["hw_time"].shape[1]
    dead_hw = np.arange(HW)[None, :] >= a["hw_cnt"][:, None]
    for k in ("hw_time", "hw_pkt"):
        scrub(k, dead_hw)
    TC = a["tr_time"].shape[1]
    dead_tr = np.arange(TC)[None, :] >= a["tr_cnt"][:, None]
    for k in ("tr_time", "tr_pkt", "tr_dir"):
        scrub(k, dead_tr)
    unused = ~a["sk_used"]
    for k in arrs:
        if k.startswith("sk_") and k != "sk_used":
            scrub(k, unused)
    return a
