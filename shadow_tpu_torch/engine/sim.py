"""Simulation: scenario -> device state -> run loop -> report.

Counterpart of ``shadow_tpu/engine/sim.py``: loads the scenario, builds
the topology oracle and DNS, registers hosts and their processes in the
reference's order (topology -> attach -> DNS -> ``compile_app`` ->
``make_shared``/``alloc_hosts`` -> the initial WAKE_START pushes, one
per process slot), compiles the fault schedule, then drives the window
loop ``chunk_windows`` windows at a time. Between chunks the loop
drains the packet-trace rings into pcap files, emits tracker
heartbeats, samples the network observatory, writes crash-safe
checkpoints, records the determinism digest chain, applies faults at
their exact times and honours a preemption request; with a trace or
metrics recorder installed each of these is a span and the chunk
publishes its counters.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time as _time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..apps.base import (APP_BULK, APP_BULK_SERVER, APP_GOSSIP, APP_HOSTED,
                         APP_SOCKS_CLIENT, APP_SOCKS_PROXY, APP_TGEN)
from ..apps.compile import compile_app
from ..apps.tgen import TgenTables
from ..core import rng as R
from ..core.config import Scenario
from ..core.constants import (DEFAULT_MIN_TIME_JUMP, INTERFACE_BUFFER_SIZE,
                              TCP_MSS)
from ..core.device import resolve_device
from ..core.simtime import SIMTIME_MAX, SIMTIME_ONE_SECOND
from ..net import packet as P
from ..routing.dns import DNS
from ..routing.topology import Topology, attach_hosts, build_topology
from . import defs
from .defs import EV_APP, WAKE_START
from . import checkpoint as ckpt
from .faults import CrashHook, FaultInjector, compile_faults
from .state import (EngineConfig, HostParams, Hosts, alloc_hosts,
                    make_shared)
from .window import make_plan, next_wakeup, run_windows, run_windows_graph


class Preempted(RuntimeError):
    """Raised by run() after a preemption request (``request_preempt``;
    the CLI's SIGTERM handler under ``--checkpoint``): the loop stopped
    at the next chunk boundary, saving a snapshot first when a
    checkpoint store is active. The CLI exits 75 for it."""

    def __init__(self, sim_ns: int, saved: bool):
        self.sim_ns = int(sim_ns)
        self.saved = bool(saved)
        what = ("snapshot saved" if saved
                else "no checkpoint store — nothing saved")
        super().__init__(f"run preempted at sim_ns={sim_ns} ({what})")


# process-wide preemption flag, safe to set from a signal handler;
# run() clears it on entry
_PREEMPT = threading.Event()


def request_preempt():
    """Ask the running simulation to checkpoint at the next chunk
    boundary and raise Preempted."""
    _PREEMPT.set()


@dataclass
class SimReport:
    """Aggregated results of a run."""
    stats: np.ndarray          # [H, N_STATS]
    host_names: list
    sim_time_ns: int
    wall_seconds: float
    windows: int
    heartbeats: list = field(default_factory=list)  # tracker lines
    capacity: dict = field(default_factory=dict)
    device: str = ""           # where the run executed (torch device)
    passes: int = 0            # drain passes over all windows
    memory: dict = field(default_factory=dict)  # the run's memory
    #   watermark (obs.memscope.Watermark.snapshot), the state byte
    #   census (``census``; its totals as state_bytes,
    #   state_bytes_per_host, hot_state_bytes, cold_state_bytes and
    #   the per-section bytes)
    network: dict = field(default_factory=dict)  # netscope runs: per
    #   kind (rtt/completion/queue/retx) bucket counts with exact
    #   p50/p90/p99 read-outs, the bounds, the record count and path
    faults: list = field(default_factory=list)  # applied fault events
    #   in execution order (FaultInjector.log)
    durability: dict = field(default_factory=dict)  # checkpoint saves
    #   (file, bytes, wall), the resume load wall, digest records,
    #   bytes hashed and record wall; RSTs radiated by host faults
    hosted: dict = field(default_factory=dict)  # hosted-process exit
    #   report: host name -> {"exit_status", "cause", "sim_ns", "clean",
    #   ...} (hosting.runtime.exit_info)
    device_phases: dict = field(default_factory=dict)  # passcope runs:
    #   the per-label pass table (obs.passcope.Capture.result)
    occupancy: dict = field(default_factory=dict)  # lockstep occupancy
    #   (obs.passcope.occupancy of the dense pass mix), always on
    batch: dict = field(default_factory=dict)  # batch lanes
    #   (serving.batch): {"lanes", "stacked_passes"}
    shards: int = 1            # mesh size (1: one device)
    shard_passes: list = field(default_factory=list)  # a mesh run's
    #   drain passes per shard; ``passes`` is their sum
    mesh: dict = field(default_factory=dict)  # a mesh run: processes,
    #   the torch.distributed backend (None in one process) and the
    #   bytes its collectives staged through host memory
    execution: dict = field(default_factory=dict)  # how the chunks ran
    #   (Simulation.execution_path): path ("graph": one captured CUDA
    #   graph replay a chunk; "eager"), the reason for eager, chunks,
    #   captures and their wall, replays, the graph's pool bytes and
    #   conditional nodes, host reads per chunk, native builds and disk
    #   hits of the kernel library

    def total(self, stat: int) -> int:
        return int(self.stats[:, stat].sum())

    @property
    def events(self) -> int:
        return self.total(defs.ST_EVENTS)

    @property
    def events_per_sec(self) -> float:
        return self.events / self.wall_seconds if self.wall_seconds else 0.0

    @property
    def speedup(self) -> float:
        """Simulated seconds per wallclock second."""
        if not self.wall_seconds:
            return 0.0
        return (self.sim_time_ns / SIMTIME_ONE_SECOND) / self.wall_seconds

    def capacity_report(self) -> list:
        """Per fixed-capacity array: capacity, peak occupancy across
        hosts, events lost to overflow and arrivals deferred."""
        drops = {
            "event_queue": (self.total(defs.ST_PKTS_DROP_Q) +
                            self.total(defs.ST_EQ_FULL_LOCAL)),
            "socket_table": self.total(defs.ST_SOCK_FAIL),
            "outbox": self.total(defs.ST_OUTBOX_DROP),
            "nic_txq": self.total(defs.ST_TXQ_DROP),
        }
        defers = {
            "event_queue": self.total(defs.ST_DEFER_FANIN),
            "outbox": self.total(defs.ST_DEFER_A2A),
        }
        return [{"array": name, "capacity": cap, "peak": peak,
                 "overflow": drops.get(name, 0),
                 "deferred": defers.get(name, 0)}
                for name, cap, peak in self.capacity.get("rows", [])]

    @property
    def waste_frac(self) -> float:
        """The lockstep drain's wasted-lane share: one minus the events
        run over the rows the passes stepped (passes x H). A pass may
        run two events on a row (an event and its chained NIC-TX), so
        a busy run can read below zero. ``occupancy["waste_frac"]``
        (obs.passcope) is the same figure rounded to 4 places, with
        utilization clamped at 1, so it never reads below zero. The
        reference's rung ladders count lanes differently, so neither
        is a parity quantity."""
        # a mesh shard's pass steps its own block of rows
        lanes = self.passes * -(-len(self.host_names) // self.shards)
        return 1.0 - self.events / lanes if lanes else 0.0

    def summary(self) -> dict:
        """The run's headline figures (the reference's keys). With the
        metrics registry installed they are also published as ``sim.*``
        gauges (the metrics.json ``sim`` section)."""
        mean_rtt_us = (self.total(defs.ST_RTT_SUM_US) /
                       max(self.total(defs.ST_RTT_COUNT), 1))
        sim_s = self.sim_time_ns / SIMTIME_ONE_SECOND
        s = {
            "hosts": len(self.host_names),
            "events": self.events,
            "windows": self.windows,
            "sim_seconds": sim_s,
            "wall_seconds": self.wall_seconds,
            "events_per_sec": self.events_per_sec,
            "speedup": self.speedup,
            "wall_per_sim_second": (self.wall_seconds / sim_s
                                    if sim_s else 0.0),
            "pkts_sent": self.total(defs.ST_PKTS_SENT),
            "pkts_recv": self.total(defs.ST_PKTS_RECV),
            "drop_net": self.total(defs.ST_PKTS_DROP_NET),
            "drop_buf": self.total(defs.ST_PKTS_DROP_BUF),
            "drop_q": self.total(defs.ST_PKTS_DROP_Q),
            "defer_fanin": self.total(defs.ST_DEFER_FANIN),
            "defer_a2a": self.total(defs.ST_DEFER_A2A),
            "bytes_recv": self.total(defs.ST_BYTES_RECV),
            "retransmits": self.total(defs.ST_RETRANSMIT),
            "sack_reneges": self.total(defs.ST_SACK_RENEGE),
            "transfers_done": self.total(defs.ST_XFER_DONE),
            "transfers_aborted": self.total(defs.ST_TGEN_ABORT),
            "mean_rtt_us": mean_rtt_us,
            "device": self.device,
            "passes": self.passes,
            "waste_frac": self.waste_frac,
            "shards": self.shards,
        }
        if self.execution:
            ex = self.execution
            s["path"] = ex["path"]
            if ex.get("reason"):
                s["path_reason"] = ex["reason"]
            s["captures"] = ex["captures"]
            s["replays"] = ex["replays"]
            s["host_reads_per_chunk"] = ex["host_reads_per_chunk"]
            s["native_builds"] = ex["native_builds"]
            s["disk_hits"] = ex["disk_hits"]
        if self.memory:
            s["mem_peak_bytes"] = int(self.memory.get("peak_bytes", 0))
            s["mem_source"] = self.memory.get("source")
            s["state_bytes_per_host"] = int(
                self.memory.get("state_bytes_per_host", 0))
        # exact tails from the netscope histograms
        if self.network:
            kinds = self.network.get("kinds", {})
            s["rtt_p50_us"] = kinds.get("rtt", {}).get("p50_us", 0)
            s["rtt_p99_us"] = kinds.get("rtt", {}).get("p99_us", 0)
            s["completion_p99_s"] = (
                kinds.get("completion", {}).get("p99_us", 0) / 1e6)
        if self.occupancy:
            s["lane_utilization"] = self.occupancy.get("utilization")
            from ..obs import passcope as PC
            lbl, frac = PC.top_pass(self.device_phases)
            if lbl is not None:
                s["top_pass"] = lbl
                s["top_pass_frac"] = frac
        if self.faults:
            s["faults_applied"] = len(self.faults)
        if self.hosted:
            s["hosted_exits"] = len(self.hosted)
            s["hosted_failures"] = sum(
                1 for v in self.hosted.values() if not v.get("clean", False))
        from ..obs import metrics as MT
        if MT.ENABLED:
            MT.REGISTRY.publish("sim", s)
        return s


def auto_engine_config(scenario: Scenario, topo: Topology) -> EngineConfig:
    """Size the fixed-capacity buffers from the scenario: the outbox
    covers one lookahead window of the fastest link, fan-in gets twice
    that, queues hold the inbound burst plus timers, all clamped so
    memory stays bounded at large H."""
    H = scenario.total_hosts()
    min_jump = topo.min_latency_ns or DEFAULT_MIN_TIME_JUMP

    bw = 0
    for _idx, _name, spec in scenario.expand_hosts():
        bw = max(bw, spec.bandwidth_up or 0, spec.bandwidth_down or 0)
    if topo.v_bw_up_bytes.size:
        bw = max(bw, int(topo.v_bw_up_bytes.max()),
                 int(topo.v_bw_down_bytes.max()))
    if bw <= 0:
        bw = 128 * 1024 * 1024

    pkts_per_window = (bw * min_jump) // (TCP_MSS * 10**9) + 1

    def pow2(n, lo, hi):
        v = lo
        while v < n and v < hi:
            v *= 2
        return v

    def pow2_floor(n):
        return 1 << max(n, 1).bit_length() - 1

    slot_budget = 1 << 24
    hi_q = max(32, min(1024, pow2_floor(slot_budget // max(H, 1))))
    hi_ob = max(16, min(512, pow2_floor(slot_budget // (4 * max(H, 1)))))

    obcap = pow2(int(pkts_per_window * 5 // 4), 16, hi_ob)
    incap = pow2(2 * obcap, 32, 2 * hi_ob)
    qcap = max(pow2(incap + 32, 32, hi_q), incap + 32)
    return EngineConfig(num_hosts=H, qcap=qcap, scap=16, obcap=obcap,
                        incap=incap, txqcap=16)


def chunk_path(device, graph: bool = True, hosted: bool = False,
               mesh=None, passcope: bool = False, clock=None) -> tuple:
    """("graph", None) when a run's chunks run as replays of one
    captured CUDA graph — every modeled run on cuda: single-device, a
    batch of lanes, or a mesh whose shards share one card in this
    process — else ("eager", reason). The configuration decides, never
    a caught error: a graph run whose capture or build fails raises.
    ``graph=False`` asks for the eager loop on the card (the
    graph=eager comparison)."""
    from ..parallel import shard as SH
    if device.type != "cuda":
        return "eager", f"device {device.type}"
    if hosted:
        return "eager", "hosted apps (the CPU tier runs between windows)"
    if mesh is not None and mesh.comm.multiprocess:
        return "eager", ("a multi-process mesh (its collectives run "
                         "between processes)")
    if mesh is not None and not SH.one_device(mesh):
        return "eager", "a mesh over several cards in one process"
    if passcope:
        return "eager", "passcope (its labels need eager launches)"
    if clock is not None:
        return "eager", "a per-phase clock"
    if not graph:
        return "eager", "graph=False"
    return "graph", None


class Simulation:
    """Build and run one scenario on one torch device (``cuda`` unless
    the caller names another)."""

    def __init__(self, scenario: Scenario, topology: Topology = None,
                 engine_cfg: EngineConfig = None, seed: int = None,
                 device=None):
        self.device = resolve_device(device)
        self.scenario = scenario
        seed = scenario.seed if seed is None else seed
        self.seed = seed

        src = topology or scenario.topology_graphml or scenario.topology_path
        self.topo = src if isinstance(src, Topology) else build_topology(src)

        H = scenario.total_hosts()
        self.cfg = engine_cfg or auto_engine_config(scenario, self.topo)
        if self.cfg.num_hosts != H:
            raise ValueError(f"engine config sized for {self.cfg.num_hosts} "
                             f"hosts, scenario has {H}")

        self.dns = DNS()
        names, hints = [], []
        for idx, name, spec in scenario.expand_hosts():
            names.append(name)
            hints.append((spec.ip_hint, spec.geocode_hint, spec.type_hint))
            self.dns.register(idx, name,
                              spec.ip_hint if spec.quantity == 1 else None)
        self.host_names = names

        vertex = attach_hosts(self.topo, hints, seed=seed)

        bw_up = np.zeros(H, dtype=np.int64)
        bw_down = np.zeros(H, dtype=np.int64)
        nic_buf = np.full(H, INTERFACE_BUFFER_SIZE, dtype=np.int64)
        cpu_cost = np.zeros(H, dtype=np.int64)
        cpu_threshold = np.full(H, -1, dtype=np.int64)
        rcvbuf0 = np.full(H, -1, dtype=np.int64)
        sndbuf0 = np.full(H, -1, dtype=np.int64)
        PP = max((len(s.processes) for _, _, s in
                  scenario.expand_hosts() if s.processes), default=1)
        if self.cfg.procs_per_host < PP:
            self.cfg = dataclasses.replace(self.cfg, procs_per_host=PP)
        PP = self.cfg.procs_per_host
        app_kind = np.zeros((H, PP), dtype=np.int32)
        app_cfg = np.zeros((H, PP, 8), dtype=np.int64)
        start_times = np.zeros((H, PP), dtype=np.int64)
        has_app = np.zeros((H, PP), dtype=bool)
        pcap_on = np.zeros(H, dtype=bool)

        # every tgen process of the scenario compiles into one set of
        # shared tables
        tgen_tables = TgenTables()
        hosted_specs = []   # (host, process slot, name, app, arguments)
        for idx, name, spec in scenario.expand_hosts():
            v = vertex[idx]
            bw_up[idx] = (spec.bandwidth_up or self.topo.v_bw_up_bytes[v]
                          or 1 << 40)
            bw_down[idx] = (spec.bandwidth_down
                            or self.topo.v_bw_down_bytes[v] or 1 << 40)
            if spec.interface_buffer:
                nic_buf[idx] = spec.interface_buffer
            if spec.socket_recv_buffer:
                rcvbuf0[idx] = spec.socket_recv_buffer
            if spec.socket_send_buffer:
                sndbuf0[idx] = spec.socket_send_buffer
            pcap_on[idx] = spec.pcap
            if spec.cpu_frequency:
                ratio = (scenario.cpu_raw_frequency_khz /
                         max(spec.cpu_frequency, 1))
                cost = int(scenario.cpu_event_cost_ns * ratio)
                prec = scenario.cpu_precision_ns
                if prec and prec > 0:
                    cost = ((cost + prec // 2) // prec) * prec
                cpu_cost[idx] = cost
                cpu_threshold[idx] = scenario.cpu_threshold_ns
            for p, proc in enumerate(spec.processes):
                kind, cfg_words = compile_app(proc.plugin, proc.arguments,
                                              self.dns, H,
                                              tgen_tables=tgen_tables)
                app_kind[idx, p] = kind
                app_cfg[idx, p] = cfg_words
                start_times[idx, p] = proc.start_time
                has_app[idx, p] = True
                if proc.plugin.startswith("hosted:"):
                    # beside modeled processes is fine (the op replay
                    # stamps the hosted slot); two hosted processes on
                    # one host are not: wake records carry no process
                    if any(i == idx for i, *_ in hosted_specs):
                        raise ValueError(
                            f"host {name!r} declares two hosted "
                            "processes; at most one per host (modeled "
                            "processes alongside are fine)")
                    hosted_specs.append(
                        (idx, p, name, proc.plugin[len("hosted:"):],
                         proc.arguments))
        gsel = (app_kind == APP_GOSSIP) & has_app
        if gsel.any():
            n_draw = int(app_cfg[gsel, 0].max())
            bad = int((~gsel.any(axis=1)[:n_draw]).sum())
            if bad:
                import sys
                sys.stderr.write(
                    f"shadow_tpu_torch: warning: gossip peer range "
                    f"n={n_draw} covers {bad} non-gossip host id(s); "
                    "their relay datagrams are silently dropped\n")
        tg_nodes, tg_peers, tg_pool, tg_edges = tgen_tables.arrays()
        if tgen_tables.sync_slots > self.cfg.synccap:
            self.cfg = dataclasses.replace(self.cfg,
                                           synccap=tgen_tables.sync_slots)

        # dead-branch knobs the reference derives from the apps: which
        # app kinds exist and whether TCP can be opened at all
        if self.cfg.app_kinds is None:
            kinds = tuple(sorted(set(int(k) for k in app_kind.ravel())))
            tcp_kinds = {APP_TGEN, APP_BULK, APP_BULK_SERVER, APP_HOSTED,
                         APP_SOCKS_CLIENT, APP_SOCKS_PROXY}
            self.cfg = dataclasses.replace(
                self.cfg, app_kinds=kinds,
                uses_tcp=bool(tcp_kinds & set(kinds)))
        if (cpu_cost > 0).any() and not self.cfg.cpu_model:
            self.cfg = dataclasses.replace(self.cfg, cpu_model=True)
        if pcap_on.any() and self.cfg.tracecap == 0:
            chunk = min(self.cfg.chunk_windows, 16)
            self.cfg = dataclasses.replace(
                self.cfg, chunk_windows=chunk,
                tracecap=chunk * (self.cfg.obcap + self.cfg.incap))

        # CPU-hosted apps (hosting/): real app code bridged per window
        self.hosting = None
        if hosted_specs:
            from ..hosting.api import lookup
            from ..hosting.runtime import HostingRuntime
            apps = {idx: lookup(app)(args)
                    for idx, _, _, app, args in hosted_specs}
            # zero-arg factories: a host_up restart respawns a FRESH
            # instance (engine.faults)
            factories = {idx: (lambda an=app, ar=args: lookup(an)(ar))
                         for idx, _, _, app, args in hosted_specs}
            self.hosting = HostingRuntime(
                apps, {idx: n for idx, _, n, _, _ in hosted_specs},
                self.dns, seed,
                procs={idx: p for idx, p, _, _, _ in hosted_specs},
                factories=factories)
            if self.cfg.scap > 256:
                raise ValueError(
                    f"hosted apps require scap <= 256 (got "
                    f"{self.cfg.scap}): pipe handles pack the slot "
                    "into 8 bits")
            if self.cfg.hostedcap < 32:
                # every wake one window can bring (several accepts) must
                # fit the ring
                self.cfg = dataclasses.replace(self.cfg, hostedcap=32)

        # the fault schedule: compiled here so bad configs fail at
        # build, applied by the run loop at exact sim times
        self.injector = None
        if scenario.faults:
            events = compile_faults(
                scenario.faults,
                {name: idx for idx, name, _ in scenario.expand_hosts()},
                vertex, topo=self.topo, stop_time=scenario.stop_time)
            procs_of_host = {
                int(h): [int(p) for p in np.flatnonzero(has_app[h])]
                for h in range(H) if has_app[h].any()}
            self.injector = FaultInjector(
                events, self.topo.latency_ns, self.topo.reliability,
                vertex, procs_of_host, names)
            self.injector.hosting = self.hosting

        dev = self.device

        def t(a, dt):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        hid = torch.arange(H, dtype=torch.int32, device=dev)
        self.hp = HostParams(
            hid=hid,
            rng_stream=R.stream_of(seed, R.DOMAIN_HOST, hid).to(torch.uint32),
            vertex=t(vertex, torch.int32),
            bw_up=t(bw_up, torch.int64),
            bw_down=t(bw_down, torch.int64),
            app_kind=t(app_kind, torch.int32),
            app_cfg=t(app_cfg, torch.int64),
            nic_buf=t(nic_buf, torch.int64),
            cpu_cost=t(cpu_cost, torch.int64),
            cpu_threshold=t(cpu_threshold, torch.int64),
            rcvbuf0=t(rcvbuf0, torch.int64),
            sndbuf0=t(sndbuf0, torch.int64),
            pcap_on=t(pcap_on, torch.bool),
        )

        min_jump = self.topo.min_latency_ns or DEFAULT_MIN_TIME_JUMP
        self.sh = make_shared(self.topo.latency_ns, self.topo.reliability,
                              scenario.stop_time, min_jump, dev, seed=seed,
                              cc_kind=self.cfg.cc_kind, tgen_nodes=tg_nodes,
                              tgen_peers=tg_peers, tgen_pool=tg_pool,
                              tgen_edges=tg_edges, host_vertex=vertex,
                              host_bw_up=bw_up, host_bw_down=bw_down)

        # initial events: one process start per slot, in slot order
        eq_time = np.full((H, self.cfg.qcap), SIMTIME_MAX, np.int64)
        eq_kind = np.zeros((H, self.cfg.qcap), np.int32)
        eq_seq = np.zeros((H, self.cfg.qcap), np.int32)
        eq_pkt = np.zeros((H, self.cfg.qcap, P.PKT_WORDS), np.int32)
        eq_ctr = np.zeros(H, np.int32)
        for p in range(PP):
            idxs = np.flatnonzero(has_app[:, p])
            eq_time[idxs, p] = start_times[idxs, p]
            eq_kind[idxs, p] = EV_APP
            eq_seq[idxs, p] = eq_ctr[idxs]
            eq_pkt[idxs, p, P.ACK] = WAKE_START
            eq_pkt[idxs, p, P.SEQ] = -1
            eq_pkt[idxs, p, P.SRC] = p
            eq_ctr[idxs] += 1
        self.hosts = alloc_hosts(self.cfg, dev)
        self.hosts.eq_time.copy_(t(eq_time, torch.int64))
        self.hosts.eq_kind.copy_(t(eq_kind, torch.int32))
        self.hosts.eq_seq.copy_(t(eq_seq, torch.int32))
        self.hosts.eq_pkt.copy_(t(eq_pkt, torch.int32))
        self.hosts.eq_ctr.copy_(t(eq_ctr, torch.int32))
        self.hosts.eq_next.copy_(t(eq_time.min(axis=1), torch.int64))
        self._ran = False
        self._pscope = None
        self._devices = None    # a mesh run's devices
        self._warm_mesh = None  # (mesh, ShardedState, Shared): prewarm's

    def execution_path(self, mesh=None, passcope: bool = False,
                       clock=None, graph: bool = True) -> tuple:
        """This run's :func:`chunk_path`."""
        return chunk_path(self.device, graph, hosted=self.hosting is not None,
                          mesh=mesh, passcope=passcope, clock=clock)

    def _shard(self, mesh, hosts, hp, sh, resumed: bool = False):
        """This run's state on `mesh` -> (ShardedState, the padded
        Shared): stacked when every shard shares one device and no
        hosted app runs; the one ``prewarm(mesh)`` built (whose graph it
        captured) when run on the same mesh from the start."""
        from ..parallel import shard as SH
        warm, self._warm_mesh = self._warm_mesh, None
        if warm is not None and warm[0] is mesh and not resumed:
            return warm[1], warm[2]
        hosts_p, hp_p, sh_p, cfg_p = self._pad_for_mesh(mesh.size, hosts,
                                                        hp, sh)
        ss = SH.device_put_sharded(
            hosts_p, hp_p, sh_p, cfg_p, mesh,
            stacked=SH.one_device(mesh) and self.hosting is None)
        return ss, sh_p

    def prewarm(self, mesh=None, digest_every: int = 0) -> dict:
        """Build or load the kernel library and capture the chunk graph
        this scenario's run would capture, WITHOUT running it: the
        fleet's pre-warm entry point (serving.prewarm; CLI
        ``--prewarm``), the port of the reference's ``prewarm``. The
        chunk shrinks to 1 under hosted apps and to the digest cadence
        when `digest_every` > 0, as run() does. The graph goes into the
        process's memory tier (core.jitcache), keyed by this state's
        tensors, so this Simulation's run() replays it; a `mesh` is the
        sharded chunk (the state sharded now, which run() on the same
        mesh takes over). A graph cannot outlive its process, so the
        disk tier (serving.aotcache) keeps the library only. On an eager
        path (the CPU, hosted apps, shards over several cards or
        processes) nothing is captured.

        Returns {"fingerprint", "chunk", "shards", "cache_scope",
        "captured", "path"}."""
        from ..core import jitcache as JC
        from ..obs.ledger import ENGINE, fingerprint_of
        chunk = self.effective_chunk(digest_every)
        path, why = self.execution_path(mesh)
        if mesh is None:
            scope = JC.cache_scope(self.cfg, chunk)
        else:
            scope = JC.sharded_scope(self._pad_cfg(mesh.size), chunk, mesh)
        out = {"fingerprint": fingerprint_of(self.cfg, engine=ENGINE),
               "chunk": chunk,
               "shards": 1 if mesh is None else mesh.size,
               "cache_scope": scope, "captured": False, "path": path}
        if path == "graph" and mesh is None:
            from .window import chunk_graph
            chunk_graph(self.hosts, self.hp, self.sh, self.cfg, chunk,
                        make_plan(self.cfg, self.hp, self.sh))
            out["captured"] = True
        elif path == "graph":
            from ..parallel import shard as SH
            ss, sh_p = self._shard(mesh, self.hosts, self.hp, self.sh)
            SH.sharded_graph(ss, chunk, SH.sharded_plan(ss))
            self._warm_mesh = (mesh, ss, sh_p)
            out["captured"] = True
        elif why:
            out["reason"] = why
        return out

    def effective_chunk(self, digest_every: int = 0) -> int:
        """Windows per run_windows call: 1 under hosted apps (the CPU
        tier runs between windows), shrunk to the digest cadence so
        records land on exact window boundaries."""
        chunk = 1 if self.hosting is not None else self.cfg.chunk_windows
        if digest_every:
            chunk = min(chunk, digest_every)
        return chunk

    def run(self, clock=None, checkpoint_path: str = None,
            checkpoint_every_s: float = 0, checkpoint_keep: int = 0,
            resume_from: str = None, resume_unchecked: bool = False,
            digest: str = None, digest_every: int = 0,
            digest_context: dict = None, digest_rewind: bool = True,
            heartbeat_s: float = 0, logger=None, pcap_dir: str = None,
            trace: str = None, metrics: str = None,
            netscope: str = None, passcope: str = None,
            verbose: bool = False, mesh=None,
            graph: bool = True) -> SimReport:
        """Run to the stop time. The state tensors are updated in place;
        the final state stays in ``self.hosts`` (``self.final_hosts``).
        `clock` is passed to ``window.run_windows`` (per-phase wall
        split).

        `mesh` (``parallel.shard.make_mesh`` or
        ``parallel.dist.global_mesh``) block-shards the hosts over its
        shards, with the same results bit for bit: the host count is
        padded to a multiple of the mesh size with inert rows, cut off
        again before stats, digests and checkpoints, and the features
        that read the whole state (digest, checkpoints, faults, hosted
        apps, pcap, tracker, netscope) gather it at chunk boundaries and
        write back what they change. ``self.final_hosts`` is the
        gathered state. On a multi-process mesh every process runs the
        same loop (the gathers are collectives), only process 0 writes
        files, and hosted apps and faults are refused, as in the
        reference.

        `checkpoint_path` + `checkpoint_every_s` write snapshots into a
        crash-safe rotating store (``engine.checkpoint``; the last
        `checkpoint_keep`, default 3, are kept); `resume_from` restores
        one (a .npz, or a store base for its newest valid snapshot) and
        re-arms the fault schedule. `resume_unchecked` downgrades the
        fingerprint check to a warning.

        `digest` appends the determinism digest chain (``obs.digest``)
        every `digest_every` windows (default 64), at every fault batch
        and at the end, plus ``<digest>.manifest.json``; the chunk
        shrinks to the cadence. On resume the chain file is rewound to
        the snapshot's stamped position, so the finished chain equals
        an uninterrupted run's; `digest_rewind=False` records a fresh
        chain of the resumed tail instead. An already installed
        recorder takes this run's records and the path is ignored.

        Telemetry, as in the reference: `heartbeat_s` > 0 emits tracker
        heartbeats on that sim-time interval (``obs.tracker``, through
        `logger` when given); `pcap_dir` writes a pcap file per host
        with ``logpcap`` from the packet-trace ring (``obs.pcap``);
        `netscope` streams the per-chunk network time-series to that
        path (``obs.netscope``; needs ``EngineConfig.netscope``, and
        ``SimReport.network`` holds the exact percentiles either way);
        `trace` writes a Chrome trace-event timeline (``obs.trace``) and
        `metrics` a metrics.json snapshot plus per-chunk lines at
        ``<metrics>.chunks.jsonl`` (``obs.metrics``). None of them
        changes a result. A trace or metrics recorder already installed
        process-wide takes this run's records and the path is
        ignored.

        `passcope` traces the first chunks (``SHADOW_TPU_PASSCOPE_CHUNKS``,
        default 8) with torch.profiler and attributes them to the pass
        labels (``obs.passcope``): ``SimReport.device_phases``, and
        passcope.json in that directory. Unset, ``SHADOW_TPU_PASSCOPE``
        enables it the same way (empty: ``passcope_trace``). Profiling
        is observation only. ``SimReport.occupancy`` is always set.

        On cuda, a modeled run — single-device, or on a mesh whose
        shards share one card in this process — replays one captured
        CUDA graph a chunk (``execution_path``; ``graph=False`` keeps
        the eager loop), with the same results bit for bit;
        ``SimReport.execution`` says which path ran and why."""
        if self._ran:
            raise RuntimeError("Simulation objects are single-use")
        self._ran = True
        # a preemption flag left by an earlier run must not stop this one
        _PREEMPT.clear()
        import sys
        from ..obs import digest as DG
        from ..obs import metrics as MT
        from ..obs import trace as TR
        own_dg = own_tr = own_mt = False
        # on a multi-process mesh only process 0 writes files
        writer = (mesh is None or not mesh.comm.multiprocess
                  or mesh.comm.rank == 0)
        if digest is not None:
            if not DG.ENABLED:
                DG.install(digest, every=digest_every or DG.DEFAULT_EVERY,
                           context=digest_context, writer=writer)
                own_dg = True
            else:
                sys.stderr.write(
                    "shadow_tpu_torch: warning: a digest recorder is "
                    "already installed process-wide; the path passed to "
                    "run() is ignored\n")
        if trace is not None and not TR.ENABLED:
            TR.install(trace if writer else None)
            own_tr = True
        if metrics is not None and not MT.ENABLED:
            MT.install(metrics if writer else None,
                       jsonl_path=(metrics + ".chunks.jsonl" if writer
                                   else None))
            own_mt = True
        if (trace is not None and not own_tr) or (
                metrics is not None and not own_mt):
            sys.stderr.write(
                "shadow_tpu_torch: warning: a trace/metrics recorder is "
                "already installed process-wide; the path passed to "
                "run() is ignored\n")
        try:
            return self._run_impl(clock, checkpoint_path,
                                  checkpoint_every_s, checkpoint_keep,
                                  resume_from, resume_unchecked,
                                  digest_rewind, heartbeat_s, logger,
                                  pcap_dir, netscope, passcope, verbose,
                                  mesh, writer, graph)
        finally:
            if self._pscope is not None:
                # a run that raised must not leave the labels on
                self._pscope.stop()
            # no hosted child outlives the run, whatever ended it (a
            # resume respawns and fast-forwards them from the journals)
            if self.hosting is not None:
                self.hosting.shutdown()
            if own_tr:
                TR.finish()
            if own_mt:
                MT.finish()
            if own_dg:
                DG.finish()

    def _run_impl(self, clock, checkpoint_path, checkpoint_every_s,
                  checkpoint_keep, resume_from, resume_unchecked,
                  digest_rewind, heartbeat_s, logger, pcap_dir,
                  netscope, passcope, verbose, mesh=None,
                  writer=True, graph=True) -> SimReport:
        from ..obs import digest as DG
        from ..obs import memscope as MS
        from ..obs import metrics as MT
        from ..obs import netscope as NSC
        from ..obs import passcope as PC
        from ..obs import trace as TR
        if TR.ENABLED:
            s0 = TR.TRACER.now()
        # with --trace/--metrics off, the obs layer costs the chunk loop
        # this one boolean
        obs_on = TR.ENABLED or MT.ENABLED
        dg = DG.RECORDER if DG.ENABLED else None
        st, hp, sh, cfg = self.hosts, self.hp, self.sh, self.cfg
        H = cfg.num_hosts
        inj = self.injector
        if mesh is not None:
            from ..parallel import shard as SH
        multiproc = mesh is not None and mesh.comm.multiprocess
        if multiproc:
            # the reference's messages, with the ROADMAP item
            if self.hosting is not None:
                raise NotImplementedError(
                    "hosted apps + multi-process mesh not supported "
                    "(ROADMAP A11b)")
            if inj is not None:
                raise NotImplementedError(
                    "fault injection + multi-process mesh not supported "
                    "(host-fault surgery needs addressable state; "
                    "ROADMAP A11b)")
        narrow = not cfg.wide_state
        durability = {"saves": [], "load_s": None}
        if checkpoint_path and not checkpoint_every_s:
            raise ValueError(
                "checkpoint_path requires checkpoint_every_s > 0 "
                "(otherwise no snapshot would ever be written)")
        if netscope and not cfg.netscope:
            raise ValueError(
                "run(netscope=...) requires EngineConfig.netscope=True "
                "(the histograms are allocated at Simulation "
                "construction)")
        tracker = None
        if heartbeat_s:
            from ..obs.tracker import Tracker, socket_columns
            tracker = Tracker(int(heartbeat_s * 10**9), self.host_names,
                              logger)
        # with the knob on, records accumulate in memory; the path adds
        # the JSONL stream
        nsrec = (NSC.NetScope(netscope if writer else None)
                 if cfg.netscope else None)
        pcap = None
        pcap_run = bool(cfg.tracecap) and pcap_dir is not None
        if pcap_run and writer:
            from ..obs.pcap import PcapWriter
            pcap = PcapWriter(pcap_dir, self.host_names,
                              self.dns.ip_array(H),
                              np.flatnonzero(hp.pcap_on.cpu().numpy()))
        wm = MS.Watermark(self.device if mesh is None
                          else SH.mesh_local_devices(mesh))
        pc_dir = (passcope if passcope is not None
                  else os.environ.get("SHADOW_TPU_PASSCOPE"))
        if pc_dir == "":
            pc_dir = "passcope_trace"
        pscope = (PC.Capture(pc_dir, self.device) if pc_dir and writer
                  else None)
        self._pscope = pscope
        # the fleet's liveness signal: under a fleet worker
        # (SHADOW_TPU_FLEET_RUN_DIR) each chunk touches
        # <run_dir>/heartbeat, which the watchdog reads
        hb_dir = os.environ.get("SHADOW_TPU_FLEET_RUN_DIR")
        hb_path = os.path.join(hb_dir, "heartbeat") if hb_dir else None
        fingerprint = ckpt.scenario_fingerprint(self.scenario, cfg,
                                                self.seed)
        store = (ckpt.CheckpointStore(checkpoint_path,
                                      keep=checkpoint_keep)
                 if checkpoint_path else None)
        hosting = self.hosting
        if store is not None and hosting is not None:
            # checkpointed hosted runs journal every child's shim stream,
            # so a resume can fast-forward respawned children (armed
            # before any child spawns)
            hosting.enable_journal()
        crash = CrashHook.from_env()
        if dg is not None:
            dg.write_manifest(DG.build_manifest(
                self.scenario, cfg, self.seed, sh, self.host_names, dg,
                self.device, checkpoint_path=checkpoint_path,
                shards=1 if mesh is None else mesh.size,
                pcap=pcap_dir is not None, faults=inj is not None,
                hosted=hosting is not None))
        chunk = self.effective_chunk(dg.every if dg is not None else 0)
        from ..core import flow as FL
        from ..core import jitcache as JC
        from ..serving import aotcache as AC
        path, path_why = self.execution_path(mesh, pscope is not None, clock,
                                             graph)
        graph = path == "graph"
        plan = make_plan(cfg, hp, sh) if mesh is None else None
        ex0 = (FL.STATS["host_reads"], JC.STATS["compiles"],
               JC.STATS["compile_wall_s"], JC.STATS["replays"],
               AC.STATS["builds"], AC.STATS["disk_hits"])
        n_chunks = 0
        # the real stop time: a segment's Shared may carry the next
        # fault's time as its stop time instead
        stop_ns = int(sh.stop_time)
        min_jump = int(sh.min_jump)

        def window_after(nt):
            return nt, (SIMTIME_MAX if nt == SIMTIME_MAX else nt + min_jump)

        ws, we = window_after(int(st.eq_next.min()))
        total_windows = passes = 0

        if resume_from:
            t0 = _time.perf_counter()
            snap = ckpt.load(resume_from, st, fingerprint,
                             strict=not resume_unchecked, narrow=narrow)
            for name, arr in snap.hosts.items():
                getattr(st, name).copy_(torch.from_numpy(arr))
            ws, we, total_windows = snap.wstart, snap.wend, snap.windows
            if inj is not None:
                if snap.fault_idx < 0:
                    raise ValueError(
                        "snapshot records no fault schedule position "
                        "(__fault_idx__); it was taken by a run "
                        "without this fault config — refusing to "
                        "resume into one")
                sh = inj.fast_forward(snap.fault_idx, sh)
            if hosting is not None:
                if snap.hosted_blob is None:
                    raise ValueError(
                        "scenario hosts real processes but the snapshot "
                        "has no hosted sidecar (<snapshot>.npz.hosted) — "
                        "it was taken without hosted-app support")
                # rebuild the hosted tier; respawned children fast-
                # forward by journal replay
                hosting.restore(snap.hosted_blob)
            self._sync()
            durability["load_s"] = _time.perf_counter() - t0

        # a mesh run: the shards take the (resumed) state over
        ss = None
        lane_rows = H           # the rows one drain pass steps
        if mesh is not None:
            ss, sh = self._shard(mesh, st, hp, sh, bool(resume_from))
            mplan = SH.sharded_plan(ss) if graph else None
            st = self.hosts = None
            lane_rows = ss.lcfg.num_hosts
            self._devices = SH.mesh_local_devices(mesh)
        shard_passes = [0] * (1 if mesh is None else mesh.size)

        def whole(names=None):
            """The state's real rows: the single run's Hosts, or the
            mesh's gathered (just the fields `names`, when given; a
            collective on a multi-process mesh)."""
            if ss is None:
                return st
            return SH.gather(ss, H, names=names)

        def dg_record(kind, window, sim_ns):
            if TR.ENABLED:
                d0 = TR.TRACER.now()
            dg.record(whole(), H, window, sim_ns, kind,
                      hosted=(hosting.digest_state()
                              if hosting is not None else None))
            if TR.ENABLED:
                TR.TRACER.complete("digest.record", d0,
                                   args={"window": window, "kind": kind})
            if MT.ENABLED:
                reg = MT.REGISTRY
                reg.counter("digest.records").inc()
                reg.gauge("digest.last_window").set(window)
                reg.gauge("digest.bytes_hashed").set(dg.bytes_hashed)

        if dg is not None:
            if resume_from and snap.digest_records >= 0 and digest_rewind:
                dg.rewind(snap.digest_records, snap.digest_chain)
                if dg.due(total_windows):
                    # the cadence record due at the snapshot's own
                    # boundary, which the crashed attempt never wrote
                    dg_record("cadence", total_windows, min(ws, stop_ns))
            else:
                dg.begin_run(total_windows)

        every_ns = int(checkpoint_every_s * 10**9) if store else 0
        ckpt_at = ws + every_ns if every_ns else None

        def save_snapshot(ws_now):
            # stamps the fault schedule and chain positions, so records
            # and faults after this save are re-produced on resume
            t0 = _time.perf_counter()
            hosts = whole()
            if not writer:
                return
            path = store.save(
                hosts, ws_now, we, total_windows, fingerprint,
                fault_idx=inj.i if inj is not None else -1,
                digest_records=len(dg.records) if dg is not None else -1,
                digest_chain=dg.chain_hex if dg is not None else None,
                hosted_blob=(hosting.snapshot() if hosting is not None
                             else None),
                narrow=narrow)
            durability["saves"].append(
                {"file": path, "bytes": os.path.getsize(path),
                 "wall_s": _time.perf_counter() - t0, "sim_ns": ws_now})

        def events_now():
            if ss is not None:
                return sum(v[0] for v in SH.scalars(
                    ss, lambda s: s.stats[:, defs.ST_EVENTS].sum().view(1)))
            return int(st.stats[:, defs.ST_EVENTS].sum())

        def waste_now(events):
            lanes = passes * lane_rows
            return 1.0 - events / lanes if lanes else 0.0

        # a resumed run's restored stats already hold the earlier events
        prev_events = events_now() if obs_on and resume_from else 0
        chunk_i = 0
        self._sync()
        if TR.ENABLED:
            TR.TRACER.complete("run.setup", s0)
        wall0 = _time.perf_counter()
        if pscope is not None:
            pscope.start()
        while True:
            if hb_path is not None:
                try:
                    with open(hb_path, "w") as f:
                        f.write(f"{ws}\n")
                except OSError:
                    pass        # liveness is best-effort, never fatal
            # a multi-process mesh ignores the flag: signals reach each
            # process on its own, and a one-sided stop would wedge the
            # collectives (preempt those with SIGKILL and snapshots)
            if _PREEMPT.is_set() and not multiproc:
                saved = store is not None
                if saved:
                    save_snapshot(ws)
                if MT.ENABLED:
                    MT.REGISTRY.counter("engine.preemptions").inc()
                raise Preempted(min(ws, stop_ns), saved)
            # bound this segment at the next fault: the engine runs every
            # event before it, then the fault applies at its exact time
            sh_seg = sh
            nf = inj.next_time() if inj is not None else None
            if nf is not None and nf < stop_ns:
                sh_seg = dataclasses.replace(
                    sh, stop_time=sh.stop_time.new_tensor(nf))
            if obs_on:
                ws0 = ws
                c0 = _time.perf_counter_ns()
            if ss is None and graph:
                ws, we, n, npass = run_windows_graph(
                    st, hp, sh, ws, we, cfg, chunk, plan,
                    stop=int(sh_seg.stop_time))
            elif ss is None:
                ws, we, n, npass = run_windows(st, hp, sh_seg, ws, we, cfg,
                                               chunk, clock=clock, plan=plan)
            else:
                if graph:
                    ws, we, n, sp = SH.run_windows_sharded_graph(
                        ss, ws, we, chunk, mplan,
                        stop=int(sh_seg.stop_time))
                else:
                    ws, we, n, sp = SH.run_windows_sharded(
                        ss, ws, we, chunk, clock=clock,
                        stop=int(sh_seg.stop_time))
                if multiproc:
                    sp = [v[0] for v in mesh.comm.scalars(
                        [torch.tensor([p], device=d)
                         for p, d in zip(sp, mesh)])]
                shard_passes = [a + b for a, b in zip(shard_passes, sp)]
                npass = sum(sp)
            total_windows += n
            passes += npass
            n_chunks += 1
            if pscope is not None:
                pscope.chunk_done()
            wm.sample()
            if hosting is not None:
                if TR.ENABLED:
                    h0 = TR.TRACER.now()
                # on a mesh the CPU tier works on the gathered state,
                # written back after the step
                hst = st if ss is None else SH.gather(ss)
                hosting.step(hst, hp if ss is None else ss.hp_all, sh,
                             min(ws, stop_ns))
                if ss is not None:
                    SH.put_hosts(ss, hst)
                dropped = int(hst.hw_drop.sum())
                if dropped:
                    raise RuntimeError(
                        f"{dropped} hosted-app wakes lost to wake-ring "
                        "overflow; raise EngineConfig.hostedcap")
                # the ops may have queued events before the window the
                # engine computed: re-derive it
                ws, we = window_after(next_wakeup(hst))
                if TR.ENABLED:
                    TR.TRACER.complete("hosting.step", h0)
            now_ns = min(ws, stop_ns)
            if pcap_run:
                if TR.ENABLED:
                    p0 = TR.TRACER.now()
                tr = whole(("tr_time", "tr_pkt", "tr_cnt"))
                if pcap is not None:
                    pcap.drain(tr.tr_time.cpu().numpy(),
                               tr.tr_pkt.cpu().numpy(),
                               tr.tr_cnt.cpu().numpy())
                for s_ in ([st] if ss is None else ss.hosts):
                    s_.tr_cnt.zero_()
                if TR.ENABLED:
                    TR.TRACER.complete("pcap.drain", p0)
            if tracker is not None and tracker.due(now_ns):
                if TR.ENABLED:
                    t0 = TR.TRACER.now()
                stats_np = whole(("stats",)).stats.cpu().numpy()
                tracker.maybe_heartbeat(
                    now_ns, stats_np, socks=socket_columns(
                        whole(SOCKET_FIELDS)),
                    hosted_rss=(hosting.child_rss()
                                if hosting is not None else None),
                    dev_peak=wm.peak_bytes,
                    waste=waste_now(int(stats_np[:, defs.ST_EVENTS]
                                        .sum())))
                if TR.ENABLED:
                    TR.TRACER.complete("tracker.heartbeat", t0)
            if nsrec is not None:
                if TR.ENABLED:
                    n0 = TR.TRACER.now()
                # the host sums over hosts anyway: summing on the device
                # moves [K, B] instead of [H, K, B] (exact: integers)
                if ss is None:
                    nsrec.sample(total_windows, now_ns,
                                 st.ns_hist.sum(0).cpu().numpy(),
                                 st.stats.cpu().numpy(),
                                 conns=int(st.sk_used.sum()))
                else:
                    nsrec.sample(total_windows, now_ns,
                                 _mesh_hist(ss).cpu().numpy(),
                                 whole(("stats",)).stats.cpu().numpy(),
                                 conns=sum(v[0] for v in SH.scalars(
                                     ss, lambda s: s.sk_used.sum().view(1))))
                if TR.ENABLED:
                    TR.TRACER.complete("netscope.sample", n0)
            if store is not None and ws >= ckpt_at:
                if TR.ENABLED:
                    k0 = TR.TRACER.now()
                save_snapshot(ws)
                ckpt_at += every_ns
                if TR.ENABLED:
                    TR.TRACER.complete("checkpoint.save", k0)
            if crash is not None:
                crash.maybe_fire(ws)
            if obs_on:
                # one scalar read per chunk buys the events annotation
                ev_total = events_now()
                ev = ev_total - prev_events
                prev_events = ev_total
                if TR.ENABLED:
                    TR.TRACER.complete(
                        "chunk", c0,
                        args={"sim_ns_start": ws0, "sim_ns_end": now_ns,
                              "windows": n, "events": ev,
                              "passes": npass})
                if MT.ENABLED:
                    reg = MT.REGISTRY
                    reg.counter("engine.chunks").inc()
                    reg.counter("engine.windows").inc(n)
                    reg.counter("engine.passes").inc(npass)
                    reg.counter("engine.events").inc(ev)
                    reg.gauge("engine.sim_ns").set(now_ns)
                    chunk_wall = (_time.perf_counter_ns() - c0) / 1e9
                    chunk_sim = max(now_ns - ws0, 0) / 1e9
                    reg.chunk(
                        chunk=chunk_i, sim_ns_start=ws0,
                        sim_ns_end=now_ns, windows=n, events=ev,
                        passes=npass, wall_s=round(chunk_wall, 6),
                        events_per_sec=(round(ev / chunk_wall, 1)
                                        if chunk_wall else None),
                        wall_per_sim_second=(
                            round(chunk_wall / chunk_sim, 6)
                            if chunk_sim else None),
                        waste_frac=waste_now(ev_total))
                    if ss is not None:
                        _shard_gauges(reg, ss)
                chunk_i += 1
            if dg is not None and dg.due(total_windows):
                dg_record("cadence", total_windows, now_ns)
            if verbose:
                print(f"  t={ws / SIMTIME_ONE_SECOND:.3f}s "
                      f"windows={total_windows}")
            if nf is not None and nf < stop_ns and ws >= nf:
                if TR.ENABLED:
                    f0 = TR.TRACER.now()
                # on a mesh the surgery works on the gathered state,
                # written back with the rebuilt Shared
                fst = st if ss is None else SH.gather(ss)
                new_sh = inj.apply_batch(fst, sh)
                if graph:
                    # the captured chunk reads the tables it saw: the
                    # rebuilt ones are copied into them
                    _copy_into(sh, new_sh)
                else:
                    sh = new_sh
                if ss is not None:
                    SH.put_hosts(ss, fst)
                    SH.put_shared(ss, sh)
                # a kill's RSTs and a restart's starts may open a window
                # before the old one
                ws, we = window_after(next_wakeup(fst))
                if TR.ENABLED:
                    TR.TRACER.complete("faults.apply", f0)
                if dg is not None:
                    dg_record("fault", total_windows, nf)
            # a pending fault keeps the loop alive after the queues drain
            more_faults = (inj is not None and inj.next_time() is not None
                           and inj.next_time() < stop_ns)
            if (ws >= stop_ns or ws >= SIMTIME_MAX) and not more_faults:
                break
        if dg is not None:
            dg_record("final", total_windows,
                      min(stop_ns, ws) if ws < SIMTIME_MAX else stop_ns)
            durability.update(digest_records=len(dg.records),
                              digest_bytes=dg.bytes_hashed,
                              digest_wall_s=dg.record_wall)
        if pcap is not None:
            pcap.close()
        if TR.ENABLED:
            f0 = TR.TRACER.now()
        if ss is not None:
            st = whole()
            shard_events = [v[0] for v in SH.scalars(
                ss, lambda s: s.stats[:, defs.ST_EVENTS].sum().view(1))]
        stats = st.stats.cpu().numpy()
        self._sync()
        wall = _time.perf_counter() - wall0
        if hosting is not None:
            hosting.shutdown()
        peaks = st.cap_peaks.max(0).values.tolist()
        capacity = {"rows": [
            ("event_queue", cfg.qcap, int(peaks[0])),
            ("socket_table", cfg.scap, int(peaks[1])),
            ("outbox", cfg.obcap, int(peaks[2])),
            ("nic_txq", cfg.txqcap, int(peaks[3])),
        ]}
        sim_ns = min(stop_ns, ws) if ws < SIMTIME_MAX else stop_ns
        self.final_hosts = st
        if inj is not None:
            durability["rsts"] = inj.rsts
        wm.sample()
        memory = wm.snapshot()
        census = MS.state_census(cfg, hosts=st, hp=hp, sh=self.sh)
        memory.update(MS.census_totals(census), census=census)
        occ = PC.occupancy({"dense": (lane_rows, passes)},
                           int(stats[:, defs.ST_EVENTS].sum()), 1)
        if ss is not None:
            occ["shards"] = PC.shard_occupancy(shard_passes, shard_events,
                                               lane_rows)
        dev = pscope.result() if pscope is not None else {}
        if pscope is not None:
            PC.write_json(pc_dir, dev, occ)
        # exact percentiles from the final histograms (not the last
        # sample: a run of zero chunks still reports)
        network = {}
        if nsrec is not None:
            network = NSC.report(st.ns_hist.sum(0).cpu().numpy())
            network["records"] = len(nsrec.records)
            if nsrec.path:
                network["path"] = nsrec.path
            nsrec.close()
        g = JC.last_graph()
        execution = {
            "path": path, "reason": path_why, "chunks": n_chunks,
            "captures": JC.STATS["compiles"] - ex0[1],
            "capture_wall_s": JC.STATS["compile_wall_s"] - ex0[2],
            "replays": JC.STATS["replays"] - ex0[3],
            "pool_bytes": g.pool_bytes if graph and g else 0,
            "nodes": dict(g.nodes) if graph and g else {},
            "host_reads_per_chunk": ((FL.STATS["host_reads"] - ex0[0])
                                     / n_chunks if n_chunks else 0.0),
            "native_builds": AC.STATS["builds"] - ex0[4],
            "disk_hits": AC.STATS["disk_hits"] - ex0[5]}
        report = SimReport(stats=stats, host_names=self.host_names,
                           sim_time_ns=sim_ns, wall_seconds=wall,
                           windows=total_windows,
                           heartbeats=tracker.lines if tracker else [],
                           capacity=capacity, device=str(self.device),
                           passes=passes, memory=memory, network=network,
                           faults=list(inj.log) if inj is not None else [],
                           durability=durability,
                           hosted=(hosting.exit_info()
                                   if hosting is not None else {}),
                           device_phases=dev, occupancy=occ,
                           shards=1 if mesh is None else mesh.size,
                           shard_passes=(shard_passes if mesh is not None
                                         else []),
                           execution=execution,
                           mesh=({} if mesh is None else {
                               "processes": mesh.size // len(mesh),
                               "backend": mesh.comm.backend,
                               "host_staged_bytes":
                                   mesh.comm.staged_bytes}))
        if TR.ENABLED:
            TR.TRACER.complete("report.finalize", f0)
        if MT.ENABLED:
            MS.publish(MT.REGISTRY, memory, census=census)
            PC.publish(MT.REGISTRY, occ=occ, dev=dev or None,
                       shards=occ.get("shards"))
            for si, n_s in enumerate(shard_passes if ss is not None
                                     else ()):
                MT.REGISTRY.gauge(f"shard.passes.{si}").set(n_s)
            if network:
                NSC.publish(MT.REGISTRY, network)
            report.summary()        # publishes the sim.* gauges
            if TR.ENABLED:
                # the phase attribution into metrics.json's perf section
                # (the registry closes with this run)
                from ..obs import perf as PF
                PF.publish(PF.attribute(TR.TRACER.events, wall,
                                        report.events), MT.REGISTRY)
        return report

    def _pad_cfg(self, n_shards: int) -> EngineConfig:
        """The config with its host count padded to a multiple of
        `n_shards`."""
        H = self.cfg.num_hosts
        Hp = -(-H // n_shards) * n_shards
        return (self.cfg if Hp == H
                else dataclasses.replace(self.cfg, num_hosts=Hp))

    def _pad_for_mesh(self, n_shards: int, hosts, hp, sh):
        """Pad the host dimension to a multiple of the shard count with
        inert hosts (empty queues, no app) -> (hosts, hp, sh, cfg).
        Inert rows never emit or receive, so rows [:H] are bit-identical
        to the unpadded run's; they are cut off again before stats,
        digests and checkpoints."""
        H = self.cfg.num_hosts
        cfg = self._pad_cfg(n_shards)
        Hp = cfg.num_hosts
        if Hp == H:
            return hosts, hp, sh, self.cfg
        pad, dev = Hp - H, self.device
        fresh = alloc_hosts(dataclasses.replace(cfg, num_hosts=pad), dev)
        hosts = Hosts(**{f.name: torch.cat([getattr(hosts, f.name),
                                            getattr(fresh, f.name)])
                         for f in dataclasses.fields(Hosts)})

        def cat(t, val):
            return torch.cat([t, torch.full((pad,) + tuple(t.shape[1:]),
                                            val, dtype=t.dtype,
                                            device=t.device)])

        hp = HostParams(
            hid=torch.cat([hp.hid, torch.arange(H, Hp, dtype=torch.int32,
                                                device=dev)]),
            rng_stream=cat(hp.rng_stream, 0), vertex=cat(hp.vertex, 0),
            bw_up=cat(hp.bw_up, 1), bw_down=cat(hp.bw_down, 1),
            # app kind 0 runs no app; the words repeat a real row's, so
            # no row of a handler's unmasked arithmetic divides by zero
            app_kind=cat(hp.app_kind, 0),
            app_cfg=torch.cat([hp.app_cfg, hp.app_cfg[-1:].expand(
                (pad,) + tuple(hp.app_cfg.shape[1:]))]),
            nic_buf=cat(hp.nic_buf, 1), cpu_cost=cat(hp.cpu_cost, 0),
            cpu_threshold=cat(hp.cpu_threshold, -1),
            rcvbuf0=cat(hp.rcvbuf0, -1), sndbuf0=cat(hp.sndbuf0, -1),
            pcap_on=cat(hp.pcap_on, False))
        sh = dataclasses.replace(
            sh, host_vertex=cat(sh.host_vertex, 0),
            host_bw_up=cat(sh.host_bw_up, 1),
            host_bw_down=cat(sh.host_bw_down, 1))
        return hosts, hp, sh, cfg

    def _sync(self):
        for dev in self._devices or [self.device]:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


# the Hosts fields the tracker's socket columns read (obs.tracker)
SOCKET_FIELDS = ("sk_ooo_s", "sk_ooo_e", "sk_used", "sk_proto", "sk_rhost",
                 "sk_rport", "sk_snd_una", "sk_snd_end", "sk_sndbuf",
                 "sk_rcv_nxt", "sk_rcvbuf")


def _mesh_hist(ss):
    """The netscope histograms of a mesh, summed over its hosts."""
    return ss.mesh.comm.gather_rows(
        [s.ns_hist.sum(0, keepdim=True) for s in ss.hosts],
        ss.device).sum(0)


def _shard_gauges(reg, ss):
    """A mesh chunk's per-shard load: cumulative events and the hosts
    with a pending event per shard, and their imbalance (max/mean
    events; 1.0 is balanced)."""
    from ..parallel.shard import scalars
    vals = scalars(ss, lambda s: torch.stack([
        s.stats[:, defs.ST_EVENTS].sum(),
        (s.eq_next < SIMTIME_MAX).sum()]))
    for si, (ev, act) in enumerate(vals):
        reg.gauge(f"shard.events.{si}").set(ev)
        reg.gauge(f"shard.active_hosts.{si}").set(act)
    mean = sum(v[0] for v in vals) / len(vals)
    reg.gauge("shard.imbalance").set(
        max(v[0] for v in vals) / mean if mean else 0.0)


def _copy_into(sh, new):
    """Copy `new`'s rebuilt Shared tables into `sh`'s tensors, in place."""
    for f in dataclasses.fields(sh):
        a, b = getattr(sh, f.name), getattr(new, f.name)
        if torch.is_tensor(a) and a is not b:
            a.copy_(b)
