"""tgen: traffic-generator behavior graphs on batched rows.

Counterpart of ``shadow_tpu/apps/tgen.py``. The host half — the
behavior-graph compiler (:func:`compile_tgen_graph`, :class:`TgenTables`)
and its table encoding — is a jax-free copy of the reference's. A graph
is tgen's directed GraphML whose vertex ids name actions (``start``,
``transfer``, ``pause``, ``synchronize``, ``end``); it flattens into rows
of a node table plus peer, pause and successor pools shared by all
hosts (``Shared.tgen_*``).

The device half runs every row at once. A wake that continues a walk
puts walk cursors on a per-row stack; the walk then runs in lockstep
(:func:`_walk`): each iteration, every row with a cursor left pops one,
executes that node's action and pushes its successors, so each row
executes its cursors in the reference's order and draws its random
numbers and claims its sockets in that order. Blocking actions
(transfers, nonzero pauses, delayed starts) park their continuation on
a timer or a socket. Transfers ride TCP with the request type and size
in the SYN's tag; a per-transfer watchdog aborts a transfer past its
timeout or stallout, and the walk then goes on as after a success
(without the success accounting).
"""

from __future__ import annotations

import os
import re
from xml.etree import ElementTree

import numpy as np
import torch

from ..core import flow as FL
from ..core.kernels import pass_flags
from ..core.rowops import Slot, col_add, mput, rget, rset_where
from ..core.simtime import SIMTIME_ONE_SECOND
from ..engine.defs import (ST_APP_DONE, ST_TGEN_ABORT, ST_TGEN_DROP,
                           ST_XFER_DONE, WAKE_TIMER)
from ..net import packet as P
from ..net.tcp import tcp_close_call, tcp_connect, tcp_listen, tcp_write
from ..obs import netscope
from .base import (branch_of, cfg_words, draw, regs, schedule_wake, set_reg,
                   timer)

# --- node table encoding (Shared.tgen_nodes: int64 [N, 10]) ---
# [kind, a, b, c, next, peers_off, n_peers, sync_ref, edge_off, edge_cnt]
# `next` = first successor, kept for inspection; the walk routes only
# through the edge pool (edge_off/edge_cnt -> Shared.tgen_edges).
NK_START = 0      # a=serverport, b=initial delay ns
NK_TRANSFER = 1   # a=type (0 get, 1 put), b=size bytes,
#                   c=timeout ns, sync_ref=stallout ns
NK_PAUSE = 2      # a=fixed time ns (or -1: draw from pool[b:b+c])
NK_END = 3        # a=count limit, b=time-limit ns, c=size-limit bytes
NK_SYNC = 4       # a=indegree (arrivals required), sync_ref=counter slot
(COL_KIND, COL_A, COL_B, COL_C, COL_NEXT, COL_POFF, COL_PCNT, COL_REF,
 COL_EOFF, COL_ECNT) = range(10)
NODE_COLS = 10

# walk-cursor work stack depth (per wake); forks beyond this are
# dropped and counted in ST_TGEN_DROP
STACK_CAP = 8

# app_r register use: r2=transfers completed, r3=bytes transferred,
# r4=walk start time, r5=done flag (end conditions met)
REG_COUNT = 2
REG_BYTES = 3
REG_T0 = 4
REG_DONE = 5

# transfer request tag riding the SYN (31 usable bits)
TAG_PUT = 1 << 30
TAG_SIZE_MASK = (1 << 30) - 1

# transfer abort limits (shd-tgen-transfer.c:9-11); 0/unset in the
# graph falls back to these, exactly like the reference
DEFAULT_XFER_TIMEOUT_NS = 60 * SIMTIME_ONE_SECOND
DEFAULT_XFER_STALLOUT_NS = 15 * SIMTIME_ONE_SECOND

# watchdog timer wake: AUX sentinel (distinct from the walk
# continuations, which use aux >= 0 / small negative retry encodings)
WD_AUX = -(1 << 20)

_SIZE_RE = re.compile(r"^\s*([0-9.]+)\s*([a-zA-Z]*)\s*$")
_SIZE_UNITS = {
    "": 1, "b": 1, "byte": 1, "bytes": 1,
    "kb": 10**3, "mb": 10**6, "gb": 10**9, "tb": 10**12,
    "kib": 2**10, "mib": 2**20, "gib": 2**30, "tib": 2**40,
}


def parse_size(text: str) -> int:
    """Parse tgen size strings: '100 KiB', '1 MiB', '5242880'."""
    m = _SIZE_RE.match(str(text))
    if not m:
        raise ValueError(f"bad size {text!r}")
    val, unit = m.groups()
    mult = _SIZE_UNITS.get(unit.lower())
    if mult is None:
        raise ValueError(f"bad size unit {unit!r} in {text!r}")
    return int(float(val) * mult)


def _parse_tgen_seconds(text: str) -> int:
    """tgen times are seconds (may be fractional)."""
    return int(float(text) * SIMTIME_ONE_SECOND)


class TgenTables:
    """Accumulates compiled behavior graphs into the shared device
    tables (deduplicated per distinct graph)."""

    def __init__(self):
        self.nodes = []    # rows of NODE_COLS int64
        self.peers = []    # (host, port) int32 rows
        self.pool = []     # int64 pause choices (ns)
        self.edges = []    # int32 absolute successor-node indices
        self.sync_slots = 0  # per-host synchronize counters allocated
        self._cache = {}

    def compile(self, source: str, dns) -> int:
        """Compile a behavior graphml (path or inline text); returns the
        start-node index into the node table."""
        key = source
        if key in self._cache:
            return self._cache[key]
        start = compile_tgen_graph(source, dns, self)
        self._cache[key] = start
        return start

    def arrays(self):
        nodes = (np.asarray(self.nodes, dtype=np.int64)
                 if self.nodes else np.zeros((1, NODE_COLS), np.int64))
        peers = (np.asarray(self.peers, dtype=np.int32)
                 if self.peers else np.zeros((1, 2), np.int32))
        pool = (np.asarray(self.pool, dtype=np.int64)
                if self.pool else np.zeros((1,), np.int64))
        edges = (np.asarray(self.edges, dtype=np.int32)
                 if self.edges else np.full((1,), -1, np.int32))
        return nodes, peers, pool, edges


def _resolve_peers(text: str, dns):
    """'server1:30080,server2:30080' -> [(host_id, port), ...]"""
    out = []
    for item in str(text).split(","):
        item = item.strip()
        if not item:
            continue
        name, _, port = item.partition(":")
        out.append((dns.resolve(name), int(port or 80)))
    return out


def compile_tgen_graph(source: str, dns, tab: TgenTables) -> int:
    """Flatten one tgen behavior graphml into `tab`; returns start index."""
    if os.path.exists(source):
        with open(source) as f:
            text = f.read()
    else:
        text = source
    root = ElementTree.fromstring(text)
    ns = ""
    if root.tag.startswith("{"):
        ns = root.tag[: root.tag.index("}") + 1]

    keys = {}  # key id -> attr name
    for k in root.iter(f"{ns}key"):
        keys[k.attrib["id"]] = k.attrib["attr.name"]

    graph = root.find(f"{ns}graph")
    if graph is None:
        raise ValueError("tgen graphml has no <graph>")

    raw = {}      # node id -> attr dict
    order = []    # node ids in file order
    for nd in graph.findall(f"{ns}node"):
        attrs = {}
        for d in nd.findall(f"{ns}data"):
            attrs[keys.get(d.attrib["key"], d.attrib["key"])] = (d.text or "")
        raw[nd.attrib["id"]] = attrs
        order.append(nd.attrib["id"])

    succs = {nid: [] for nid in order}   # node id -> successor ids (file order)
    indeg = {nid: 0 for nid in order}    # node id -> incoming edge count
    for e in graph.findall(f"{ns}edge"):
        s, t = e.attrib["source"], e.attrib["target"]
        if s in succs and t in indeg:
            succs[s].append(t)
            indeg[t] += 1

    base = len(tab.nodes)
    index = {nid: base + i for i, nid in enumerate(order)}

    def action_of(nid: str) -> str:
        for prefix in ("start", "transfer", "pause", "synchronize", "end"):
            if nid.startswith(prefix):
                return prefix
        raise ValueError(f"tgen node id {nid!r} names no known action")

    default_peers = None
    # graph-wide abort limits from the start node (pre-scanned: file
    # order does not guarantee start first); the reference's fallback
    # chain is transfer attr -> start attr -> built-in default
    # (shd-tgen-action.c:476-487,810, shd-tgen-transfer.c:972-973)
    default_timeout = DEFAULT_XFER_TIMEOUT_NS
    default_stallout = DEFAULT_XFER_STALLOUT_NS
    for nid in order:
        if action_of(nid) == "start":
            a = raw[nid]
            if a.get("timeout"):
                default_timeout = (_parse_tgen_seconds(a["timeout"])
                                   or DEFAULT_XFER_TIMEOUT_NS)
            if a.get("stallout"):
                default_stallout = (_parse_tgen_seconds(a["stallout"])
                                    or DEFAULT_XFER_STALLOUT_NS)
    rows = []
    for nid in order:
        a = raw[nid]
        act = action_of(nid)
        slist = [index[t] for t in succs[nid]]
        nxt = slist[0] if slist else -1
        eoff, ecnt = len(tab.edges), len(slist)
        tab.edges.extend(slist)
        poff = pcnt = 0
        if act == "start":
            peers = _resolve_peers(a.get("peers", ""), dns)
            if peers:
                poff = len(tab.peers)
                pcnt = len(peers)
                tab.peers.extend(peers)
                default_peers = (poff, pcnt)
            port = int(a.get("serverport", 0) or 0)
            delay = _parse_tgen_seconds(a["time"]) if a.get("time") else 0
            row = [NK_START, port, delay, 0, nxt, poff, pcnt, 0, eoff, ecnt]
        elif act == "transfer":
            ttype = 1 if a.get("type", "get").lower() == "put" else 0
            size = parse_size(a.get("size", "1 MiB"))
            if a.get("peers"):
                peers = _resolve_peers(a["peers"], dns)
                poff, pcnt = len(tab.peers), len(peers)
                tab.peers.extend(peers)
            elif default_peers:
                poff, pcnt = default_peers
            else:
                # the reference tgen errors the same way: a transfer
                # with neither its own peers nor start-node peers
                raise ValueError(
                    f"tgen transfer node {nid!r} has no peers (set a "
                    "'peers' attr on it or on the start node)")
            tmo = (_parse_tgen_seconds(a["timeout"]) if a.get("timeout")
                   else 0) or default_timeout
            stl = (_parse_tgen_seconds(a["stallout"]) if a.get("stallout")
                   else 0) or default_stallout
            row = [NK_TRANSFER, ttype, size, tmo, nxt, poff, pcnt, stl,
                   eoff, ecnt]
        elif act == "pause":
            t = a.get("time", "1")
            if "," in t:
                choices = [_parse_tgen_seconds(x)
                           for x in t.split(",") if x.strip()]
                ref = len(tab.pool)
                tab.pool.extend(choices)
                row = [NK_PAUSE, -1, ref, len(choices), nxt, 0, 0, 0, eoff,
                       ecnt]
            else:
                row = [NK_PAUSE, _parse_tgen_seconds(t), 0, 0, nxt, 0, 0, 0,
                       eoff, ecnt]
        elif act == "synchronize":
            # join barrier: fires after `indegree` cursor arrivals
            sref = tab.sync_slots
            tab.sync_slots += 1
            row = [NK_SYNC, max(indeg[nid], 1), 0, 0, nxt, 0, 0, sref, eoff,
                   ecnt]
        else:  # end
            count = int(a.get("count", 0) or 0)
            tlim = _parse_tgen_seconds(a["time"]) if a.get("time") else 0
            slim = parse_size(a["size"]) if a.get("size") else 0
            row = [NK_END, count, tlim, slim, nxt, 0, 0, 0, eoff, ecnt]
        rows.append(row)
    tab.nodes.extend(rows)

    if "start" not in index:
        raise ValueError("tgen graph has no 'start' node")

    # Reject walks that can spin forever on device: the subgraph of
    # transitions that complete instantly (no timer, no socket) must be
    # acyclic, or the walk loop would chain through a cycle unboundedly
    # within one wake. Blocking nodes: transfers, pauses with a
    # guaranteed-nonzero wait, delayed starts, and multi-arrival
    # synchronize barriers.
    def blocks(local_i: int) -> bool:
        r = rows[local_i]
        if r[COL_KIND] == NK_TRANSFER:
            return True
        if r[COL_KIND] == NK_PAUSE:
            if r[COL_A] > 0:
                return True
            if r[COL_A] < 0:  # drawn from pool: blocking iff no 0 choice
                lo, n = r[COL_B], r[COL_C]
                return min(tab.pool[lo:lo + n]) > 0
            return False
        if r[COL_KIND] == NK_START:
            return r[COL_B] > 0
        if r[COL_KIND] == NK_SYNC:
            return r[COL_A] > 1
        return False

    WHITE, GRAY, BLACK = 0, 1, 2

    # iterative DFS over the non-blocking subgraph
    def succ_local(i):
        r = rows[i]
        return [tab.edges[r[COL_EOFF] + j] - base for j in range(r[COL_ECNT])]

    state = [WHITE] * len(rows)
    for root_i in range(len(rows)):
        if state[root_i] != WHITE or blocks(root_i):
            continue
        stack = [(root_i, 0)]
        state[root_i] = GRAY
        while stack:
            i, j = stack[-1]
            ss = [s for s in succ_local(i) if not blocks(s)]
            if j < len(ss):
                stack[-1] = (i, j + 1)
                s = ss[j]
                if state[s] == GRAY:
                    names = [order[x] for x, _ in stack] + [order[s]]
                    raise ValueError(
                        "tgen graph cycle never blocks (no transfer or "
                        f"nonzero pause): {' -> '.join(names)}")
                if state[s] == WHITE:
                    state[s] = GRAY
                    stack.append((s, 0))
            else:
                state[i] = BLACK
                stack.pop()

    return index["start"]


# --- device side: the walk on batched rows ---------------------------------

_I32 = torch.int32
_I64 = torch.int64

# walk start per row (the `mode` of _walk)
_NO_WALK, _ENTER, _SUCC = 0, 1, 2


def _rows(sh, name):
    """Rows of one scenario's copy of the tgen table `name`."""
    return getattr(sh, name).shape[0] // sh.lanes


def _tab(sh, name, i):
    """Table `name` at the per-row index `i`, already clamped into one
    scenario's copy; stacked lanes (engine.state.LaneShared) read their
    own lane's copy."""
    if sh.lanes == 1:
        return getattr(sh, name)[i]
    return getattr(sh, name)[i + sh.tgen_base[name]]


def _node(sh, cur):
    """[H, NODE_COLS] node rows of the per-row node index `cur`
    (clamped into the table, as the reference does)."""
    n = _rows(sh, "tgen_nodes")
    return _tab(sh, "tgen_nodes", cur.to(_I64).clamp(0, n - 1))


def _index(arr, slot):
    """arr[h, slot[h]] under the reference's direct indexing, which
    these reads use instead of its one-hot ``rget``: a negative slot
    counts from the end of the table, then the index is clamped into
    it (a slot of -1 reads the last socket)."""
    n = arr.shape[1]
    i = torch.where(slot < 0, slot + n, slot).clamp(0, n - 1)
    return arr.gather(1, i.to(_I64).unsqueeze(1)).squeeze(1)


def _pick(u, off, cnt):
    """off + min(int64(u * f32(cnt)), cnt - 1): a uniform pick of one of
    `cnt` pool entries (one float32 multiply, then truncation)."""
    return off + torch.minimum((u * cnt.to(torch.float32)).to(_I64), cnt - 1)


def _exec_node(st, hp, sh, now, ex, cur, nd, kinds, proceed):
    """Execute the entry action of node `cur` on the rows in `ex` whose
    node kind `kinds[k]` says some row of `ex` holds, or-ing into the
    [H] `proceed` (in place) the rows whose walk continues through all
    the node's out-edges. A row that does not proceed parked its cursor
    on a timer or a socket, or the cursor ended (end, synchronize)."""
    kind = nd[:, COL_KIND].clamp(0, 4)

    @FL.when(kinds[NK_START])
    def _():
        mk = ex & (kind == NK_START)
        delay = nd[:, COL_B]
        wait = mk & (delay > 0)
        timer(st, wait, now + delay, aux=cur)
        proceed.logical_or_(mk & ~wait)

    @FL.when(kinds[NK_TRANSFER])
    def _():
        mk = ex & (kind == NK_TRANSFER)
        pcnt = nd[:, COL_PCNT].clamp(min=1)
        u = draw(st, hp, mk)
        pick = _pick(u, nd[:, COL_POFF], pcnt).clamp(
            0, _rows(sh, "tgen_peers") - 1)
        peer = _tab(sh, "tgen_peers", pick)
        size = nd[:, COL_B].clamp(max=TAG_SIZE_MASK)
        tag = (size | torch.where(nd[:, COL_A] == 1, TAG_PUT, 0)).to(_I32)
        slot, ok = tcp_connect(st, hp, sh, mk, now, dst_host=peer[:, 0],
                               dst_port=peer[:, 1], tag=tag)
        # client sockets remember their owning node, so any number of
        # transfers (parallel walk branches) can be in flight
        mc = mk & ok
        rset_where(st.sk_app_ref, slot, mc, cur)
        _wd_arm(st, mc, now, slot, 0, nd[:, COL_C], nd[:, COL_REF])
        # socket table full: retry the transfer after 1 s (a negative
        # aux re-enters the node itself)
        timer(st, mk & ~ok, now + SIMTIME_ONE_SECOND, aux=-(cur + 1))

    @FL.when(kinds[NK_PAUSE])
    def _():
        mk = ex & (kind == NK_PAUSE)
        fixed = nd[:, COL_A]
        drawn = fixed < 0
        u = draw(st, hp, mk & drawn)
        at = _pick(u, nd[:, COL_B], nd[:, COL_C].clamp(min=1))
        pool = _tab(sh, "tgen_pool",
                    at.clamp(0, _rows(sh, "tgen_pool") - 1))
        t = torch.where(drawn, pool, fixed)
        wait = mk & (t > 0)
        timer(st, wait, now + t, aux=cur)
        proceed.logical_or_(mk & ~wait)

    @FL.when(kinds[NK_END])
    def _():
        mk = ex & (kind == NK_END)
        r = regs(st)
        a, b, c = nd[:, COL_A], nd[:, COL_B], nd[:, COL_C]
        met = (((a > 0) & (r[:, REG_COUNT] >= a))
               | ((b > 0) & (now - r[:, REG_T0] >= b))
               | ((c > 0) & (r[:, REG_BYTES] >= c)))
        stop = mk & met
        set_reg(st, stop, REG_DONE, 1)
        col_add(st.stats, ST_APP_DONE, stop)
        proceed.logical_or_(mk & ~met)

    @FL.when(kinds[NK_SYNC])
    def _():
        # join barrier: fires once as many cursors as the node has
        # in-edges have arrived, then resets so loops re-arm
        mk = ex & (kind == NK_SYNC)
        ref = nd[:, COL_REF].to(_I32)
        cnt = rget(st.tgen_sync, ref) + 1
        fire = cnt >= nd[:, COL_A].to(_I32)
        rset_where(st.tgen_sync, ref, mk, torch.where(fire, 0, cnt))
        proceed.logical_or_(mk & fire)


def _push_succs(st, sh, stack, sp, m, cur, n_edges: int):
    """Push node `cur`'s successors on the cursor stack of each row in
    `m` (in place; the rows' edge counts are at most `n_edges`, the
    scenario's largest out-degree); a push past STACK_CAP drops the
    branch and counts it in ST_TGEN_DROP."""
    nd = _node(sh, cur)
    eoff = nd[:, COL_EOFF].to(_I32)
    ecnt = nd[:, COL_ECNT].to(_I32)
    at = torch.arange(STACK_CAP, device=sp.device)
    last = _rows(sh, "tgen_edges") - 1
    for j in range(n_edges):
        mj = m & (j < ecnt)
        tgt = _tab(sh, "tgen_edges", (eoff + j).clamp(0, last).to(_I64))
        can = sp < STACK_CAP
        stack.copy_(torch.where(mj.unsqueeze(1) & (at == sp.unsqueeze(1)),
                                tgt.unsqueeze(1), stack))
        sp.add_((mj & can).to(_I32))
        col_add(st.stats, ST_TGEN_DROP, mj & ~can)


def _walk(st, hp, sh, now, mode, node, n_edges: int):
    """Run each row's walk until every cursor has blocked or ended.

    `mode` says how a row's walk starts at `node`: _ENTER executes the
    node's action, _SUCC continues past it (its action completed) into
    all its successors; _NO_WALK rows take no part. The rows run in
    lockstep, one cursor per row per iteration, each in its own order;
    a _SUCC row's first iteration only pushes the successors, as the
    reference does before its loop, so it gets one iteration more. A
    row stops after 4 * N + 4 * STACK_CAP iterations (N: rows of the
    node table); the cursors it has left count in ST_TGEN_DROP.

    The iterations are a ``flow.while_``: each reads which node kinds
    execute (codes 0-4) and whether any row pops a cursor at all (5:
    popped, not executed) through ``kernels.pass_flags``, and the
    cursor stacks, stack pointers and iteration count are updated in
    place. `n_edges` is the scenario's largest out-degree."""
    H = mode.shape[0]
    dev = mode.device
    stack = torch.full((H, STACK_CAP), -1, dtype=_I32, device=dev)
    stack[:, 0] = torch.where(mode != _NO_WALK, node, -1)
    sp = (mode != _NO_WALK).to(_I32)
    succ = mode == _SUCC
    cap = 4 * _rows(sh, "tgen_nodes") + 4 * STACK_CAP
    lim = cap + succ.to(_I32)
    g = torch.zeros((), dtype=_I32, device=dev)

    def step():
        active = (sp > 0) & (g < lim)
        cur = stack.gather(1, (sp - 1).clamp(min=0).to(_I64).unsqueeze(1)
                           ).squeeze(1)
        nd = _node(sh, cur)
        skip = succ & (g == 0)
        ex = active & ~skip & (regs(st)[:, REG_DONE] == 0)
        code = torch.where(ex, nd[:, COL_KIND].clamp(0, 4),
                           torch.where(active, 5, 6)).to(_I32)
        flags = pass_flags(code, None, 7, 0, 6,
                           handle=FL.loop_handle())
        kinds = FL.read(flags)
        go = kinds[7]
        if go is False:
            return False
        sp.sub_(active.to(_I32))
        proceed = active & skip
        _exec_node(st, hp, sh, now, ex, cur, nd, kinds, proceed)
        _push_succs(st, sh, stack, sp, proceed, cur, n_edges)
        g.add_(1)
        return FL.result(go)
    FL.cur().while_(True, step)
    # rows stopped by the iteration cap: their queued cursors are lost
    st.stats[:, ST_TGEN_DROP] += sp.to(_I64)


def _wd_arm(st, m, now, slot, mark, timeout_ns, stallout_ns):
    """Arm the transfer watchdog of client socket `slot` on each row in
    `m`: the next check one stallout period out, clipped to the absolute
    timeout instant. `mark` (the progress metric at arming) rides the
    wake's LEN word and the slot generation its WND word, so a recycled
    slot ignores a stale watchdog."""
    sl = Slot(slot, st.sk_used.shape[1])
    t_next = torch.minimum(now + stallout_ns,
                           sl.get(st.sk_hs_time) + timeout_ns)
    t_next = torch.maximum(t_next, now + 1)
    schedule_wake(st, m, t_next, WAKE_TIMER, sock=slot, aux=WD_AUX,
                  wnd=sl.get(st.sk_timer_gen), ln=mark)


def _observe_completion(st, m, now, slot):
    """The network observatory's completion sample: the time since the
    handshake stamp of client socket `slot`, read before the close path
    touches the slot. Issues nothing with netscope off."""
    if netscope.on(st):
        dur_us = (now - rget(st.sk_hs_time, slot)).clamp(min=0) // 1000
        netscope.observe(st, m, netscope.NS_COMPLETION, dur_us)


def app_tgen(st, hp, sh, m, now, wake, br, plan):
    b = branch_of(wake)
    slot = wake[:, P.SEQ]
    sl = Slot(slot, st.sk_used.shape[1])
    start = cfg_words(hp)[:, 0].to(_I32)
    # stale-wake guard: socket wakes carry the slot generation in WND
    fresh = wake[:, P.WND] == sl.get(st.sk_timer_gen)
    is_client = fresh & (sl.get(st.sk_app_ref) >= 0)
    # the walk each row starts once its branch has run
    mode = torch.zeros_like(slot)
    node = torch.zeros_like(slot)

    def walk_from(mw, how, at):
        mode.copy_(torch.where(mw, how, mode))
        node.copy_(torch.where(mw, at.to(_I32), node))

    @FL.when(br[0])                         # START: listen, walk
    def _():
        ms = m & (b == 0)
        port = _node(sh, start)[:, COL_A]
        tcp_listen(st, ms & (port > 0), port.to(_I32))
        set_reg(st, ms, REG_T0, now)
        walk_from(ms, _ENTER, start)

    @FL.when(br[1])                         # TIMER: watchdog or walk
    def _():
        mt = m & (b == 1)
        aux = wake[:, P.AUX]
        wd = mt & (aux == WD_AUX)
        owner = sl.get(st.sk_app_ref)
        live = wd & fresh & (owner >= 0) & sl.get(st.sk_used)
        nd = _node(sh, owner.clamp(min=0))
        metric = sl.get(st.sk_rcv_nxt) + sl.get(st.sk_snd_una)
        took = now >= sl.get(st.sk_hs_time) + nd[:, COL_C]
        # a full stallout period without progress since the mark; a
        # transfer that never made any progress stalls out too
        stalled = metric == wake[:, P.LEN].to(_I64)
        ab = live & (took | stalled)
        # abort: count it, close, and walk on without success accounting
        mput(st.sk_app_ref, sl.mask(ab), -1)
        col_add(st.stats, ST_TGEN_ABORT, ab)
        tcp_close_call(st, ab, now, sl)
        walk_from(ab, _SUCC, owner)
        _wd_arm(st, live & ~ab, now, slot, metric, nd[:, COL_C],
                nd[:, COL_REF])
        mw = mt & ~wd
        walk_from(mw, torch.where(aux >= 0, _SUCC, _ENTER),
                  torch.where(aux >= 0, aux, -aux - 1))

    @FL.when(br[3])                         # CONNECTED: a PUT writes
    def _():
        tag = _index(st.sk_syn_tag, slot)
        put = m & (b == 3) & ((tag & TAG_PUT) != 0) & is_client
        tcp_write(st, put, now, sl, (tag & TAG_SIZE_MASK).to(_I64))
        tcp_close_call(st, put, now, sl)

    @FL.when(br[5])                         # ACCEPT: serve a GET
    def _():
        tag = _index(st.sk_syn_tag, slot)
        get = m & (b == 5) & fresh & ((tag & TAG_PUT) == 0)
        tcp_write(st, get, now, sl, (tag & TAG_SIZE_MASK).to(_I64))
        tcp_close_call(st, get, now, sl)

    @FL.when(br[4])                         # EOF on a PUT-receiving child
    def _():
        # EOFs on served-GET children and on finished client sockets
        # are teardown noise
        put_child = (m & (b == 4) & ~is_client & fresh
                     & _index(st.sk_used, slot)
                     & (_index(st.sk_parent, slot) >= 0)
                     & ((_index(st.sk_syn_tag, slot) & TAG_PUT) != 0))
        tcp_close_call(st, put_child, now, sl)
        col_add(st.stats, ST_XFER_DONE, put_child)

    @FL.when(FL.any_of(br[4], br[6]))       # EOF, SENT: a transfer done
    def _():
        mf = m & ((b == 4) | (b == 6)) & is_client
        owner = sl.get(st.sk_app_ref)
        size = _node(sh, owner)[:, COL_B]
        _observe_completion(st, mf, now, slot)
        mput(st.sk_app_ref, sl.mask(mf), -1)
        tcp_close_call(st, mf, now, sl)
        r = regs(st)
        set_reg(st, mf, REG_COUNT, r[:, REG_COUNT] + 1)
        set_reg(st, mf, REG_BYTES, r[:, REG_BYTES] + size)
        col_add(st.stats, ST_XFER_DONE, mf)
        walk_from(mf, _SUCC, owner)

    @FL.when(FL.any_of(br[0], br[1], br[4], br[6]))
    def _():
        _walk(st, hp, sh, now, mode, node, plan.tgen_deg)
