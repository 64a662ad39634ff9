"""The window loop over a mesh of host shards.

Counterpart of ``shadow_tpu/parallel/shard.py``, the reference's
parallel scheduler (SURVEY §2.9) on a 1-D mesh:

- hosts are block-sharded, contiguous, so host id -> shard is
  ``hid // H_local``; each shard holds its row block of ``Hosts`` and
  ``HostParams`` on its own device, and ``Shared`` is replicated once
  per distinct device;
- the conservative window barrier is the minimum of every shard's
  earliest pending event (``pmin``), the reference's locked global
  min-next-event-time reduction;
- cross-shard delivery happens at the window boundary
  (:func:`exchange_sharded`), the reference's single cross-machine
  seam at worker_sendPacket.

The sharded run equals the single-device run bit for bit: loss rolls are
keyed by (seed, src, uid), not by placement; the received packet order
equals the single outbox order because shards are contiguous host
blocks; every per-host transition is row-local.

The exchange is a bucketed all-to-all: each shard stable-sorts its
surviving outbox by destination shard into fixed ``[S, B]`` buckets
(:func:`a2a_bucket_cap`), so it ships only what other shards take. A
bucket overflow defers the burst tail at its source with its exact
arrival stamp, counted in ST_DEFER_A2A, where the single run would
deliver it this window: bit-equality with it holds under the bucket
bound, and past it the run equals the reference's mesh run. The
reference's v1 all-gather (``EngineConfig.exchange_a2a=False``) is the
same exchange with whole-outbox buckets (``B`` = a shard's outbox),
which never overflow.

The collectives are a small interface with two implementations:
:class:`InProcess` (the shards are a Python list in this process, on
one device or several) and ``parallel.dist.Distributed``
(``torch.distributed``, several shards per process allowed). The
exchange and the window loop are written once, against it.
"""

from __future__ import annotations

import dataclasses
import types
from dataclasses import fields

import torch

from ..core.simtime import SIMTIME_MAX
from ..engine.state import EngineConfig, Hosts, Shared
from ..engine.window import (_deliver_dense, drain_window, make_plan, route,
                             settle, update_cap_peaks)
from ..obs.passcope import scope


class InProcess:
    """Collectives over shards that all live in this process. Every
    method takes one value per local shard, in shard order."""

    multiprocess = False
    rank = 0
    backend = None

    def __init__(self, devices):
        self.devices = list(devices)
        self.staged_bytes = 0       # nothing is staged through the host

    def scalars(self, vals):
        """[k] int64 tensor per shard -> every shard's values, as lists
        of Python ints (one host sync per shard)."""
        return [v.tolist() for v in vals]

    def gather_rows(self, xs, device):
        """Every shard's rows, concatenated in shard order on `device`."""
        return torch.cat([x.to(device) for x in xs])

    def all_to_all(self, bufs):
        """`bufs[i]` is shard i's [S, ...] buffer, row j bound for shard
        j -> shard j receives [S, ...], row i from shard i."""
        return [torch.stack([b[j].to(dev) for b in bufs])
                for j, dev in enumerate(self.devices)]


class Mesh(list):
    """The devices of this process's shards, in shard order, with the
    mesh's size (all processes' shards), the global index of the first
    local shard and the collectives (`comm`) that join them."""

    def __init__(self, devices, size: int = None, first: int = 0,
                 comm=None):
        super().__init__(torch.device(d) for d in devices)
        self.size = len(self) if size is None else int(size)
        self.first = int(first)
        self.comm = comm if comm is not None else InProcess(self)


def make_mesh(n: int, device=None) -> Mesh:
    """A single-process mesh of `n` shards on `device` (``cuda`` unless
    the caller names another): with k cards, shard i on
    ``cuda:(i % k)``; on one card (or a named card) all share it, as the
    reference's tests share one CPU among 8 virtual devices; ``cpu``
    puts every shard on the CPU."""
    from ..core.device import resolve_device
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        k = torch.cuda.device_count()
        return Mesh([torch.device("cuda", i % k) for i in range(n)])
    return Mesh([dev] * n)


def mesh_local_devices(mesh) -> list:
    """This process's distinct devices of the mesh, in shard order: what
    the memory watermark samples (one card holding four shards counts
    once)."""
    out = []
    for d in mesh:
        if d not in out:
            out.append(d)
    return out


@dataclasses.dataclass
class ShardedState:
    """The simulation state of this process's shards. `cfg` is the
    global config (its host count padded to the mesh), `lcfg` one
    shard's; `hp_all` the whole padded HostParams on the first shard's
    device, for the CPU tier of hosted runs."""
    mesh: Mesh
    cfg: EngineConfig
    lcfg: EngineConfig
    hosts: list
    hp: list
    sh: list
    hp_all: object

    def lo(self, k: int) -> int:
        """The first global row of local shard `k`."""
        return (self.mesh.first + k) * self.lcfg.num_hosts

    @property
    def device(self):
        return self.mesh[0]


def _rows(tree, lo: int, n: int, device, copy: bool):
    cls = type(tree)
    out = {}
    for f in fields(cls):
        t = getattr(tree, f.name)[lo:lo + n]
        out[f.name] = (t.to(device, copy=True) if copy
                       else t.to(device))
    return cls(**out)


def put_shared(ss: ShardedState, sh: Shared):
    """Replicate `sh` (a rebuilt Shared: faults rewrite its tables) once
    per distinct device of the mesh."""
    copies = {dev: Shared(**{f.name: getattr(sh, f.name).to(dev)
                             for f in fields(Shared)})
              for dev in mesh_local_devices(ss.mesh)}
    ss.sh = [copies[dev] for dev in ss.mesh]


def device_put_sharded(hosts, hp, sh, cfg: EngineConfig,
                       mesh: Mesh) -> ShardedState:
    """Split whole `hosts`/`hp` (host count a multiple of the mesh size)
    into this process's row blocks on their devices and replicate `sh`."""
    if cfg.num_hosts % mesh.size:
        raise ValueError(f"num_hosts={cfg.num_hosts} not divisible by "
                         f"{mesh.size} shards (Simulation pads "
                         "automatically)")
    lcfg = dataclasses.replace(cfg, num_hosts=cfg.num_hosts // mesh.size)
    Hl = lcfg.num_hosts
    ss = ShardedState(mesh=mesh, cfg=cfg, lcfg=lcfg, hosts=[], hp=[],
                      sh=[], hp_all=_rows(hp, 0, cfg.num_hosts,
                                          mesh[0], copy=False))
    for k, dev in enumerate(mesh):
        ss.hosts.append(_rows(hosts, ss.lo(k), Hl, dev, copy=True))
        ss.hp.append(_rows(hp, ss.lo(k), Hl, dev, copy=False))
    put_shared(ss, sh)
    return ss


def put_hosts(ss: ShardedState, hosts):
    """Write the rows of a whole `hosts` (global order; it may stop short
    of the padding rows) back into the shards, in place."""
    Hl = ss.lcfg.num_hosts
    for k, st in enumerate(ss.hosts):
        lo = ss.lo(k)
        for name in (f.name for f in fields(Hosts)):
            src = getattr(hosts, name)
            n = min(Hl, max(src.shape[0] - lo, 0))
            if n:
                getattr(st, name)[:n].copy_(src[lo:lo + n])


def gather(ss: ShardedState, rows: int = None, names=None):
    """Join the shards' rows in global order on the first shard's device,
    cut to `rows`: a whole ``Hosts``, or with `names` a namespace of just
    those fields. A collective on a multi-process mesh: every process
    calls it and gets the whole."""
    comm = ss.mesh.comm
    out = {}
    for name in names or [f.name for f in fields(Hosts)]:
        t = comm.gather_rows([getattr(st, name) for st in ss.hosts],
                             ss.device)
        out[name] = t if rows is None else t[:rows]
    return Hosts(**out) if names is None else types.SimpleNamespace(**out)


def scalars(ss: ShardedState, fn) -> list:
    """`fn(shard Hosts)` -> [k] tensor, on every shard of the mesh ->
    one list of ints per shard (all shards, in order)."""
    return ss.mesh.comm.scalars([fn(st) for st in ss.hosts])


def a2a_bucket_cap(cfg: EngineConfig, lcfg: EngineConfig) -> int:
    """Bucket slots per (source, destination) shard pair of the
    exchange: `cfg.a2acap` when set, else 4x the uniform-traffic share
    of a shard's outbox (at least 64), never more than the outbox; the
    whole outbox for the v1 exchange (``exchange_a2a=False``)."""
    Nl = lcfg.num_hosts * cfg.obcap
    n_shards = cfg.num_hosts // lcfg.num_hosts
    if not cfg.exchange_a2a:
        return Nl
    if cfg.a2acap:
        return min(cfg.a2acap, Nl)
    return min(max(64, (4 * Nl) // n_shards), Nl)


def _pack(key, arr, pkt):
    """(int64 key, int64 arrival, int32 words) -> one int32 buffer
    [..., 4 + PKT_WORDS], bit for bit: one collective moves all three."""
    lead = tuple(key.shape)
    k = key.contiguous().view(torch.int32).view(lead + (2,))
    a = arr.contiguous().view(torch.int32).view(lead + (2,))
    return torch.cat([k, a, pkt.to(torch.int32)], -1)


def _unpack(buf):
    n = buf.shape[0]
    key = buf[:, 0:2].contiguous().view(torch.int64).view(n)
    arr = buf[:, 2:4].contiguous().view(torch.int64).view(n)
    return key, arr, buf[:, 4:]


def _buckets(sortkey, arrival, pkts, H: int, Hl: int, S: int, B: int):
    """v2 source side: stable-sort the outbox by destination shard (only,
    so each shard's packets keep their outbox order) and pack
    [S, B] buckets -> (packed buckets, oj, cell_ok), `oj` the outbox
    position of each bucket slot, `cell_ok` the slots that hold one.
    The overflow tail of a bucket does not ship."""
    Nl = sortkey.shape[0]
    dev = sortkey.device
    dshard = torch.where(sortkey < H, sortkey // Hl, S)
    order_l = torch.argsort(dshard, stable=True)
    sds = dshard[order_l]
    shards_r = torch.arange(S, dtype=sds.dtype, device=dev)
    first_of = torch.searchsorted(sds, shards_r, side="left")
    count_of = torch.searchsorted(sds, shards_r, side="right") - first_of
    r = torch.arange(B, device=dev)
    j = (first_of[:, None] + r[None, :]).clamp(0, Nl - 1)
    oj = order_l[j]
    cell_ok = r[None, :] < count_of.clamp(max=B)[:, None]
    key = torch.where(cell_ok, sortkey[oj], H)
    arr = torch.where(cell_ok, arrival[oj], 0)
    pkt = torch.where(cell_ok[:, :, None], pkts[oj], 0)
    return _pack(key, arr, pkt), oj, cell_ok


def _slots(oj, cell_ok, vals, Nl: int):
    """Bucket-slot values back onto outbox positions ([Nl] bool)."""
    tgt = torch.where(cell_ok, oj, Nl).view(-1)
    out = torch.zeros(Nl + 1, dtype=torch.bool, device=oj.device)
    out[tgt] = vals.view(-1)
    return out[:Nl]


def exchange_sharded(ss: ShardedState, seed: int):
    """The window-boundary exchange over the mesh, in place.

    Source side, per shard: routing, the SYN latency stamp and the loss
    roll (``engine.window.route``, the single exchange's own), then the
    ``[S, B]`` buckets by destination shard and the all-to-all.
    Destination side, per shard: the single exchange's stable sort and
    ``_deliver_dense`` over the received list, offset to the shard's
    rows. The accept flags travel back to the sources by the reverse
    all-to-all, so what a destination cannot take stays in its source
    outbox, in ST_DEFER_FANIN, and a bucket's overflow in ST_DEFER_A2A.
    The tail is ``engine.window.settle``: tx trace records, counts,
    carry, merge."""
    cfg, comm = ss.cfg, ss.mesh.comm
    H, Hl = cfg.num_hosts, ss.lcfg.num_hosts
    S, Nl = ss.mesh.size, ss.lcfg.num_hosts * cfg.obcap
    B = a2a_bucket_cap(cfg, ss.lcfg)
    src, bk = [], []
    for st, sh in zip(ss.hosts, ss.sh):
        pkts, stimes, arrival, valid, deliver, dst = route(st, sh, seed, H)
        src.append((pkts, stimes, arrival, valid, deliver))
        bk.append(_buckets(torch.where(deliver, dst, H), arrival, pkts, H,
                           Hl, S, B))
    recv = [r.reshape(S * B, -1)
            for r in comm.all_to_all([b[0] for b in bk])]

    dest = []
    for k, (st, buf) in enumerate(zip(ss.hosts, recv)):
        g_key, g_arr, g_pkt = _unpack(buf)
        order = torch.argsort(g_key, stable=True)
        nfree = (st.eq_time == SIMTIME_MAX).sum(1)
        in_pkt, in_time, kept_sorted = _deliver_dense(
            nfree, order, g_key[order], g_pkt, g_arr, cfg.incap, cfg,
            lo=ss.lo(k))
        kept = torch.zeros(g_key.shape[0], dtype=torch.bool,
                           device=g_key.device)
        kept[order] = kept_sorted
        dest.append((in_pkt, in_time, kept))

    back = comm.all_to_all([d[2].view(S, B).to(torch.uint8) for d in dest])
    for k, st in enumerate(ss.hosts):
        pkts, stimes, arrival, valid, deliver = src[k]
        oj, cell_ok = bk[k][1], bk[k][2]
        settle(st, ss.hp[k], cfg, pkts, stimes, arrival, deliver,
               valid & ~deliver, _slots(oj, cell_ok, back[k] > 0, Nl),
               _slots(oj, cell_ok, torch.ones_like(cell_ok), Nl),
               dest[k][0], dest[k][1])


@torch.inference_mode()
def run_windows_sharded(ss: ShardedState, wstart: int, wend: int,
                        max_windows: int, clock=None, stop: int = None):
    """``engine.window.run_windows`` over the mesh, in place.

    The drain is shard-local: each shard runs only the passes its own
    rows need (and a hosted shard's wake-ring pause is its own). The
    advance is global: the minimum over shards of the next event and of
    the next carried arrival, with the anti-livelock rule on the summed
    outbox counts before and after the exchange. `stop` overrides the
    Shared stop time (a fault segment's bound). Returns (wstart',
    wend', windows_run, passes): `passes` holds each local shard's
    drain passes, the imbalance signal."""
    tick = clock or (lambda _label: None)
    sh0 = ss.sh[0]
    stop = int(sh0.stop_time) if stop is None else int(stop)
    min_jump, seed = int(sh0.min_jump), int(sh0.seed32)
    passes = [0] * len(ss.hosts)
    plans = [make_plan(ss.lcfg, hp, sh) for hp, sh in zip(ss.hp, ss.sh)]
    ws, we, i, nq = wstart, wend, 0, None
    while i < max_windows and ws < stop and ws < SIMTIME_MAX:
        we_eff = min(we, stop)
        with scope("drain"):
            if nq is None:
                nq = min(v[0] for v in scalars(
                    ss, lambda st: st.eq_next.min().view(1)))
            ran = nq < we_eff
            for k, st in enumerate(ss.hosts):
                passes[k] += drain_window(st, ss.hp[k], ss.sh[k], we_eff,
                                          ss.lcfg, plans[k])
        tick("drain")
        with scope("cap_peaks"):
            for st in ss.hosts:
                update_cap_peaks(st)
        with scope("exchange.sharded"):
            ob0 = sum(v[0] for v in scalars(
                ss, lambda st: st.ob_cnt.sum().view(1)))
            if ob0:     # an empty exchange is the identity
                exchange_sharded(ss, seed)
        with scope("cap_peaks"):
            for st in ss.hosts:
                update_cap_peaks(st)
        tick("exchange")
        with scope("advance"):
            vals = scalars(ss, lambda st: torch.stack([
                st.ob_cnt.sum().to(torch.int64), st.eq_next.min(),
                torch.minimum(st.eq_next.min(), st.ob_next.min())]))
            nq = min(v[1] for v in vals)
            # anti-livelock: a window that executed nothing and shipped
            # nothing re-opens at the earliest queue event
            progressed = ran or sum(v[0] for v in vals) < ob0
            nt = min(v[2] for v in vals) if progressed else nq
            ws, we = nt, (SIMTIME_MAX if nt == SIMTIME_MAX
                          else nt + min_jump)
        tick("advance")
        i += 1
    return ws, we, i, passes
