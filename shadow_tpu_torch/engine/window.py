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

The reference runs a chunk of windows as one compiled ``while_loop``.
Here the chunk (:func:`run_chunk`) is written against the current
``core.flow``: a ``while_`` over windows holding the drain's
``while_`` over passes, each handler branch under ``when`` on its own
pass flag (``core.kernels.pass_flags``), the exchange under ``when`` on
the outboxes' packet count, and the window boundaries in
``core.kernels.advance``, with the window scalars on the device
(``W``). Under the eager flow (:func:`run_windows`: the CPU, hosted
apps, passcope, ``graph=False``) each predicate is read on the host,
one read a pass for the flags and one for the due-now NIC-TX chain,
and two a window; on cuda a run captures the chunk once as a CUDA
graph of conditional nodes and replays it (:func:`run_windows_graph`),
reading the host once a chunk. Stacked scenario lanes have their own
form of the chunk (:func:`run_chunk_lanes`, a row of window scalars a
lane, ``core.kernels.advance_lanes``), eager
(:func:`run_windows_batch`) or captured (:func:`run_windows_batch_graph`);
the mesh's is ``parallel.shard.run_chunk_sharded``. A value one
conditional body hands to code after it is written in place.

Not ported, because the reference holds them bit-identical to the dense
drain and the single full sort: the compaction rung ladders, window
rungs, the hot/cold split, event batching and the compacted exchange
paths.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..apps.base import (N_APP_KINDS, N_BRANCHES, branch_of, dispatch,
                         process_of)
from ..core import flow as FL
from ..core import kernels as K
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


@dataclass(frozen=True)
class Plan:
    """What the configuration and the scenario fix for a chunk: the
    pass-flag vector's layout (the ``_N_CODES`` codes, then the feature
    bits, then the go-on flag), the flags the scenario can raise, the
    app kinds present and the loops' static bounds. Built on the host
    before the chunk (:func:`make_plan`); a captured chunk bakes it in,
    so it is part of the graph's signature."""
    bits: tuple          # feature bit names, in bit order
    possible: tuple      # per flag: can some row raise it
    kinds: tuple         # app kinds present
    phold_seed: int      # the largest phold c4, clamped to the queue
    tgen_deg: int        # the largest tgen out-degree
    seed: int            # the loss roll's root

    @property
    def n_bits(self) -> int:
        return len(self.bits)

    @property
    def i_cont(self) -> int:
        return _N_CODES + len(self.bits)

    def mask(self, name: str) -> int:
        return 1 << self.bits.index(name) if name in self.bits else 0

    def flag(self, v, name: str):
        """Feature bit `name`'s predicate in the read flags `v`."""
        return v[_N_CODES + self.bits.index(name)]


def make_plan(cfg: EngineConfig, hp, sh) -> Plan:
    """The chunk's :class:`Plan` (host reads of `hp` and `sh`)."""
    from ..apps.base import APP_PHOLD, APP_TGEN
    bits = (_TCP_PARTS if cfg.uses_tcp else ()) + (
        ("blocked",) if cfg.cpu_model else ()) + (
        ("paused",) if cfg.hostedcap > 1 else ())
    ak = hp.app_kind
    kinds = tuple(sorted(int(k) for k in torch.unique(ak).tolist()
                         if int(k) in _ported_kinds()))
    codes = [False] * _N_CODES
    for k in (EV_PKT, EV_NIC_TX) + ((EV_TCP_TIMER, EV_TCP_CLOSE)
                                    if cfg.uses_tcp else ()):
        codes[k] = True
    for k in kinds:
        for b in range(N_BRANCHES):
            codes[_app_code(k, b)] = True
    n_seed = 0
    if APP_PHOLD in kinds:
        c4 = torch.where(ak == APP_PHOLD, hp.app_cfg[..., 4], 0)
        n_seed = int(c4.clamp(0, cfg.qcap).max())
    deg = 0
    if APP_TGEN in kinds and sh.tgen_nodes.shape[0]:
        from ..apps.tgen import COL_ECNT
        deg = max(int(sh.tgen_nodes[:, COL_ECNT].max()), 0)
    return Plan(bits=bits, possible=tuple(codes) + (True,) * (len(bits) + 1),
                kinds=kinds, phold_seed=n_seed, tgen_deg=deg,
                seed=int(sh.seed32) if sh.lanes == 1 else 0)


def _ported_kinds():
    from ..apps.base import _ported_apps
    return _ported_apps()


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

        @FL.when(FL.any_of(parts["rst"], parts["accept"], parts["conn"]))
        def _():
            with scope("tcp.rx"):
                slot = sock_demux(st, pkt[:, P.SRC], pkt[:, P.SPORT],
                                  pkt[:, P.DPORT], P.PROTO_TCP)
                tcp.tcp_rx(st, hp, sh, md & is_tcp & (slot >= 0), now,
                           slot, pkt_in, parts)

    @FL.when(parts.get("udp", True))
    def _():
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


def _features(st, kind, pkt, t, cfg: EngineConfig, blocked):
    """[H] int32 words of the pass's feature bits (the Plan's ``bits``
    order), or None when the config has none."""
    rows = []
    if cfg.uses_tcp:
        rows.append(_tcp_features(st, kind, pkt, t))
    if blocked is not None:
        rows.append(blocked[None])
    if cfg.hostedcap > 1:
        # the hosted pause: stop before any wake ring can overflow, so
        # the CPU tier drains it (the window re-opens after the step);
        # the floor keeps tiny rings from wedging the loop
        cap = max(st.hw_time.shape[1] - 4, 1)
        rows.append((st.hw_cnt >= cap)[None])
    if not rows:
        return None
    f = torch.cat(rows).to(torch.int32)
    bit = torch.arange(f.shape[0], dtype=torch.int32, device=f.device)
    return (f << bit[:, None]).sum(0, dtype=torch.int32)


def step_all_hosts(st, hp, sh, wend, cfg: EngineConfig, plan: Plan,
                   lane_passes=None, W=None):
    """One lockstep pass: every host whose earliest event lies below
    `wend` pops and runs it. The pass's flags (``core.kernels.
    pass_flags``) say which handler branches have rows; each branch runs
    under ``flow.when`` on its own flag. Returns the go-on flag: under
    the eager flow a bool, False (having changed nothing) when no host
    has an event below `wend` or a hosted wake ring is near full; under
    a captured flow ``flow.result`` (the kernel set the pass loop's
    handle), the pass with nothing to run changing nothing.

    `wend` is an int, a device scalar, or a [rows] tensor holding each
    row's own window end (stacked lanes); `lane_passes` ([B] int64, a
    lane's or a shard's block of rows each), when given, counts the
    passes in which each block had a row to step; `W` (the window
    scalars, or stacked lanes' batch row), when given, counts the pass
    in W[W_PASSES]."""
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
    code = torch.where(kind == EV_APP,
                       _app_code(app_kind, branch_of(pkt)), kind)
    present = K.pass_flags(code.to(torch.int32),
                           _features(st, kind, pkt, t, cfg, blocked),
                           _N_CODES, plan.n_bits, EV_NULL,
                           plan.mask("blocked"), plan.mask("paused"),
                           handle=FL.loop_handle())
    v = FL.read(present, plan.possible)
    cont = v[plan.i_cont]
    if cont is False:
        return False
    if W is not None:
        FL.count(W[K.W_PASSES:K.W_PASSES + 1],
                 present[plan.i_cont:plan.i_cont + 1])
    if lane_passes is not None:
        lane_passes += stepped.view(lane_passes.shape[0], -1).any(1)
    parts = {n: plan.flag(v, n) for n in _TCP_PARTS if n in plan.bits}

    if cfg.cpu_model:
        @FL.when(plan.flag(v, "blocked"))
        def _():
            equeue.q_clear_slot(st, blocked, slot)
            equeue.q_push(st, blocked, torch.maximum(st.cpu_avail, t + 1),
                          pop_kind, pkt)
    equeue.q_clear_slot(st, ready, slot)
    if plan.kinds:
        dispatch(st, hp, sh, kind == EV_APP, t, pkt,
                 {k: [v[_app_code(k, b)] for b in range(N_BRANCHES)]
                  for k in plan.kinds}, proc, plan)

    @FL.when(v[EV_PKT])
    def _():
        _on_pkt(st, hp, sh, kind == EV_PKT, t, pkt, cfg, parts)

    @FL.when(v[EV_NIC_TX])
    def _():
        with scope("nic.tx"):
            nic.on_tx(st, hp, sh, kind == EV_NIC_TX, t, wend, cfg.qdisc,
                      tcp=cfg.uses_tcp, pull_tcp=parts.get("pull", False))
    if cfg.uses_tcp:
        @FL.when(v[EV_TCP_TIMER])
        def _():
            with scope("tcp.timer"):
                tcp.on_tcp_timer(st, hp, sh, kind == EV_TCP_TIMER, t, wend,
                                 pkt, expired=parts["rto"])

        @FL.when(v[EV_TCP_CLOSE])
        def _():
            tcp.on_tcp_close(st, hp, sh, kind == EV_TCP_CLOSE, t, wend,
                             pkt)

    if cfg.cpu_model:
        # every pop re-checks the CPU, so no NIC-TX is chained; the
        # event's cost is charged to the busy horizon
        set_where(st.cpu_avail, ready,
                  torch.maximum(st.cpu_avail, t) + hp.cpu_cost)
        st.stats[:, ST_EVENTS] += ready.to(torch.int64)
        return FL.result(cont)

    # Chain a due-now NIC-TX into the same pass, as the reference does:
    # executing the queue head early is what the next pass would do.
    slot2, t2 = equeue.q_min(st)
    due = ready & (t2 == t) & (rget(st.eq_kind, slot2) == EV_NIC_TX)
    if cfg.uses_tcp:
        pull2 = due & (st.txq_cnt == 0) & (st.ob_cnt < st.ob_time.shape[1])
        any_due, pull = FL.read(torch.stack([due.any(), pull2.any()]))
    else:
        (any_due,), pull = FL.read(due.any()[None]), False

    @FL.when(any_due)
    def _():
        equeue.q_clear_slot(st, due, slot2)
        with scope("nic.tx"):
            nic.on_tx(st, hp, sh, due, t, wend, cfg.qdisc,
                      tcp=cfg.uses_tcp, pull_tcp=pull)
    st.stats[:, ST_EVENTS] += ready.to(torch.int64) + due.to(torch.int64)
    return FL.result(cont)


def drain_window(st, hp, sh, wend, cfg: EngineConfig, plan: Plan = None,
                 lane_passes=None, W=None) -> int:
    """Execute every event below `wend` (an int, a device scalar, or
    each row's own): a ``flow.while_`` over passes. Returns the pass
    count under the eager flow (0 under a captured one, which counts in
    `W`)."""
    plan = plan or make_plan(cfg, hp, sh)
    n = [0]

    def one_pass():
        cont = step_all_hosts(st, hp, sh, wend, cfg, plan, lane_passes, W)
        n[0] += cont is True
        return cont
    FL.cur().while_(True, one_pass)
    return n[0]


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
    lane-local. The outbox of a lane that is not `active` ([B], non-zero
    where the lane goes on) is left as it is, as jax's batched
    while_loop leaves a finished lane's carry."""
    B, H = sh.lanes, sh.hosts
    O = st.ob_time.shape[1]
    N = B * H * O
    dev = st.ob_time.device

    pkts = st.ob_pkt.reshape(N, P.PKT_WORDS).clone()
    stimes = st.ob_time.reshape(N)
    ar_o = torch.arange(O, device=dev)
    live = (ar_o[None, :] < st.ob_cnt[:, None]).reshape(N)
    on = (active != 0).repeat_interleave(H * O)
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


def window_scalars(wstart: int, wend: int, stop: int, min_jump: int,
                   max_windows: int) -> torch.Tensor:
    """The chunk's window scalars W ([K.W_LEN] int64, on the CPU)."""
    W = [0] * K.W_LEN
    W[K.W_WS], W[K.W_WE], W[K.W_STOP] = wstart, wend, stop
    W[K.W_JUMP], W[K.W_MAXW] = min_jump, max_windows
    return torch.tensor(W, dtype=torch.int64)


def run_chunk(st, hp, sh, cfg: EngineConfig, plan: Plan, W, tick=None):
    """The chunk: up to W[W_MAXW] windows from [W[W_WS], W[W_WE]),
    never past W[W_STOP], written against the current flow (``core.
    flow``), with the window scalars on the device: a ``while_`` over
    windows holding the drain's ``while_`` over passes, the exchange
    under ``if_`` on its packet count, and the window boundaries in the
    advance kernel (``core.kernels.advance``). Under a captured flow it
    reads nothing on the host. `tick`, when given (eager only), is
    called with "drain", "exchange" and "advance" as each phase of a
    window ends."""
    tick = tick or (lambda _label: None)
    K.advance(st.eq_next, st.ob_next, st.ob_cnt, W, K.ADV_OPEN)

    def window():
        with scope("drain"):
            drain_window(st, hp, sh, W[K.W_WEFF], cfg, plan, W=W)
        tick("drain")
        with scope("cap_peaks"):
            update_cap_peaks(st)
        with scope("exchange"):
            K.advance(st.eq_next, st.ob_next, st.ob_cnt, W, K.ADV_SHIP)

            @FL.when(W[K.W_EX])     # an empty exchange is the identity
            def _():
                exchange(st, hp, sh, cfg, plan.seed)
        with scope("cap_peaks"):
            update_cap_peaks(st)
        tick("exchange")
        with scope("advance"):
            # anti-livelock: a window that executed nothing and shipped
            # nothing re-opens at the earliest queue event, not at the
            # same carried arrival (in the kernel)
            K.advance(st.eq_next, st.ob_next, st.ob_cnt, W, K.ADV_STEP,
                      handle=FL.loop_handle())
        tick("advance")
        return FL.result(W[K.W_CONT])
    FL.cur().while_(W[K.W_CONT], window)


@torch.inference_mode()
def run_windows(st, hp, sh, wstart: int, wend: int, cfg: EngineConfig,
                max_windows: int, clock=None, plan: Plan = None):
    """Execute up to `max_windows` lookahead windows in place, under the
    eager flow (each predicate read on the host).

    Returns (wstart', wend', windows_run, passes). The caller loops
    until wstart' >= stop_time or wstart' == SIMTIME_MAX. `clock`, when
    given, is called with "drain", "exchange" and "advance" as each
    phase of a window ends (a wall-time split; chip_smoke --profile).
    Runs in inference mode: nothing here needs autograd, and skipping
    its bookkeeping shortens every operation's host time. Under an
    active passcope capture each phase is a labelled range."""
    plan = plan or make_plan(cfg, hp, sh)
    W = window_scalars(wstart, wend, int(sh.stop_time), int(sh.min_jump),
                       max_windows).to(st.eq_next.device)
    run_chunk(st, hp, sh, cfg, plan, W, clock)
    ws, we, i, passes = read_scalars(W[:K.W_PASSES + 1])
    return ws, we, i, passes


def read_scalars(buf) -> list:
    """A chunk's one host read: its scalars, as a list."""
    FL.STATS["host_reads"] += 1
    return buf.tolist()


def prepare_capture(device, cfg: EngineConfig):
    """Build the tables the chunk's handlers make at first use, which a
    capture cannot (they copy from the host)."""
    if cfg.uses_tcp:
        from ..net import congestion
        congestion._tables(device)
    if cfg.netscope:
        from ..obs import netscope
        netscope.bounds(device)


def captured_chunk(sig, device, cfg: EngineConfig, n: int, body):
    """The captured chunk for the signature `sig` (``core.jitcache``
    memory tier), captured on a miss without running it: ``body(buf)``
    under inference mode, `buf` the chunk's scalars (`n` int64 values on
    `device`, the graph's ``buf``)."""
    from ..core import jitcache as JC

    def build():
        prepare_capture(device, cfg)
        buf = torch.zeros(n, dtype=torch.int64, device=device)

        def run():
            with torch.inference_mode():
                body(buf)
        g = JC.capture(run, device, keep=(buf,))
        g.buf = buf
        return g
    return JC.CHUNKS.warm(sig, build)


def replay_chunk(g, scalars) -> list:
    """One replay of a captured chunk: `scalars` (on the CPU) copied
    into its buffer, the graph run, the buffer read once."""
    g.buf.copy_(scalars)
    g.replay()
    return read_scalars(g.buf)


def chunk_graph(st, hp, sh, cfg: EngineConfig, chunk: int, plan: Plan):
    """The captured chunk for this state and plan, scope
    ``run_windows.c<chunk>.<fp>``."""
    from ..core import jitcache as JC
    return captured_chunk(
        JC.signature(JC.cache_scope(cfg, chunk), plan, (st, hp, sh)),
        st.eq_next.device, cfg, K.W_LEN,
        lambda W: run_chunk(st, hp, sh, cfg, plan, W))


def run_windows_graph(st, hp, sh, wstart: int, wend: int,
                      cfg: EngineConfig, max_windows: int, plan: Plan,
                      stop: int = None):
    """``run_windows`` as one replay of the chunk's captured CUDA graph:
    the window scalars are copied in, the graph runs every window of
    the chunk on the device, and the host reads W once at the end.
    `stop` overrides ``sh.stop_time`` (a fault segment's end)."""
    g = chunk_graph(st, hp, sh, cfg, max_windows, plan)
    ws, we, i, passes = replay_chunk(g, window_scalars(
        wstart, wend, int(sh.stop_time) if stop is None else stop,
        int(sh.min_jump), max_windows))[:K.W_PASSES + 1]
    return ws, we, i, passes


def lane_scalars(ws, we, stop, jump, max_windows: int) -> torch.Tensor:
    """The batched chunk's window scalars and the batch's row, on the
    CPU: one int64 vector of (B + 1) * W_LEN + 1, a :func:`window_scalars`
    row a lane (from the lists `ws`, `we`, `stop`, `jump`), then the
    batch's row G and its ticket (zero)."""
    return torch.cat([window_scalars(*lane, max_windows)
                      for lane in zip(ws, we, stop, jump)]
                     + [torch.zeros(K.W_LEN + 1, dtype=torch.int64)])


def lane_views(buf, B: int):
    """(W [B, W_LEN], G [W_LEN + 1]) views of a :func:`lane_scalars`
    vector."""
    return buf[:B * K.W_LEN].view(B, K.W_LEN), buf[B * K.W_LEN:]


def run_chunk_lanes(st, hp, sh, cfg: EngineConfig, plan: Plan, buf, wend):
    """:func:`run_chunk` over B lanes stacked along the row axis (``sh``
    a LaneShared), written against the current flow: a ``while_`` over
    windows while some lane goes on, the drain's ``while_`` over passes,
    the exchange under ``when`` some live lane ships, and each lane's
    window boundary in ``core.kernels.advance_lanes``. `buf` holds the
    window scalars, a row a lane, and the batch's row (:func:`lane_views`);
    `wend` ([B * H] int64) is each row's window end, written in place
    every window: the lane's W_WEFF, or 0 where the lane is frozen (its
    chunk or run has ended), so its rows pop nothing, as jax's batched
    while_loop freezes a finished lane; a frozen lane's outbox is left
    alone. Each lane counts its passes (the passes in which it had a row
    to step, which equal its run alone's) in W[:, W_PASSES], the batch
    its stacked passes in G[W_PASSES]."""
    B, H = sh.lanes, sh.hosts
    W, G = lane_views(buf, B)
    live = W[:, K.W_CONT]
    K.advance_lanes(st.eq_next, st.ob_next, st.ob_cnt, W, G, K.ADV_OPEN)

    def window():
        with scope("advance"):
            wend.view(B, H).copy_(torch.where(
                live != 0, W[:, K.W_WEFF], 0)[:, None].expand(B, H))
        with scope("drain"):
            drain_window(st, hp, sh, wend, cfg, plan, W[:, K.W_PASSES], G)
        with scope("cap_peaks"):
            update_cap_peaks(st)
        with scope("exchange"):
            K.advance_lanes(st.eq_next, st.ob_next, st.ob_cnt, W, G,
                            K.ADV_SHIP)

            @FL.when(G[K.W_EX])     # some live lane ships
            def _():
                exchange_lanes(st, hp, sh, cfg, live)
        with scope("cap_peaks"):
            update_cap_peaks(st)
        with scope("advance"):
            K.advance_lanes(st.eq_next, st.ob_next, st.ob_cnt, W, G,
                            K.ADV_STEP, handle=FL.loop_handle())
        return FL.result(G[K.W_CONT])
    FL.cur().while_(G[K.W_CONT], window)


def _lanes_split(v, B: int):
    """A batched chunk's scalars, read -> (ws, we, windows, passes:
    lists a lane; the stacked passes)."""
    rows = [v[b * K.W_LEN:(b + 1) * K.W_LEN] for b in range(B)]
    return ([r[K.W_WS] for r in rows], [r[K.W_WE] for r in rows],
            [r[K.W_I] for r in rows], [r[K.W_PASSES] for r in rows],
            v[B * K.W_LEN + K.W_PASSES])


def _lane_consts(sh):
    return sh.stop_time.tolist(), sh.min_jump.tolist()


@torch.inference_mode()
def run_windows_batch(st, hp, sh, ws, we, cfg: EngineConfig,
                      max_windows: int, plan: Plan = None):
    """``run_windows`` over B lanes stacked along the row axis (``sh`` a
    LaneShared; `ws`, `we` lists a lane): :func:`run_chunk_lanes` under
    the eager flow. Each lane runs up to `max_windows` windows of its
    own, exactly the windows its individual run would. Returns (ws',
    we', windows run, passes: lists a lane; the stacked passes)."""
    plan = plan or make_plan(cfg, hp, sh)
    dev = st.eq_next.device
    buf = lane_scalars(ws, we, *_lane_consts(sh), max_windows).to(dev)
    wend = torch.zeros_like(st.eq_next)
    run_chunk_lanes(st, hp, sh, cfg, plan, buf, wend)
    return _lanes_split(read_scalars(buf), sh.lanes)


def batch_graph(st, hp, sh, cfg: EngineConfig, chunk: int, plan: Plan):
    """The captured batched chunk for this stacked state and plan, scope
    ``run_windows_batch.c<chunk>.b<lanes>.<fp>`` (its rows' window ends
    a tensor of the graph's pool)."""
    from ..core import jitcache as JC
    return captured_chunk(
        JC.signature(JC.batch_scope(cfg, chunk, sh.lanes), plan,
                     (st, hp, sh)),
        st.eq_next.device, cfg, (sh.lanes + 1) * K.W_LEN + 1,
        lambda buf: run_chunk_lanes(st, hp, sh, cfg, plan, buf,
                                    torch.zeros_like(st.eq_next)))


def run_windows_batch_graph(st, hp, sh, ws, we, cfg: EngineConfig,
                            max_windows: int, plan: Plan):
    """:func:`run_windows_batch` as one replay of the batched chunk's
    captured CUDA graph: the lanes' window scalars are copied in, the
    graph runs every window of the chunk on the device, and the host
    reads the scalars once at the end."""
    g = batch_graph(st, hp, sh, cfg, max_windows, plan)
    return _lanes_split(replay_chunk(g, lane_scalars(
        ws, we, *_lane_consts(sh), max_windows)), sh.lanes)


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
