"""Deterministic fault injection: config -> schedule -> state surgery.

Counterpart of ``shadow_tpu/engine/faults.py``. The Simulation compiles
the scenario's faults (``<fault .../>``, ``--fault``) into a time-sorted
schedule; the run loop bounds each segment of windows at the next fault
time (the window loop's stop-time clamp), then applies every fault of
that time on the host:

- ``host_down``: every established TCP connection of the host sends one
  RST toward its peer (pushed straight into the peer's event queue,
  arriving after the current path latency), a hosted child is
  SIGKILLed through the hosting runtime, and the host's queues,
  outbox, NIC ring, app registers and socket liveness are cleared;
- ``host_up``: a hosted app is replaced by a fresh instance and process
  start events are pushed for every process slot;
- ``link_down``/``link_up``, ``loss`` and ``latency`` episodes rebuild
  the Shared latency/reliability tables from the pristine base plus the
  active episodes, so overlaps compose exactly.

Everything is a function of (config, sim time, state), so same-seed
runs are bit-identical, and equal to the reference's.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..core.simtime import SIMTIME_MAX
from ..net import packet as P
from ..net.socket import TCPS_CLOSED, TCPS_ESTABLISHED, TCPS_TIME_WAIT
from . import defs
from .defs import EV_APP, EV_NULL, EV_PKT, WAKE_START

HOST_KINDS = ("host_down", "host_up")
LINK_KINDS = ("link_down", "link_up", "loss", "latency")


@dataclass(frozen=True)
class FaultEvent:
    """One compiled, fully-resolved fault occurrence."""
    t: int            # ns
    seq: int          # config order: the (t, seq) sort is total
    kind: str         # host_down|host_up|link_down|link_up|
    #                   loss_begin|loss_end|lat_begin|lat_end
    host: int = -1    # host id (host kinds)
    va: int = -1      # attachment vertices (link kinds)
    vb: int = -1
    eid: int = -1     # episode id pairing begin/end events
    rate: float = 0.0
    extra_ns: int = 0


def _resolve_endpoint(name: str, name_to_idx: dict, vertex) -> int:
    """A fault endpoint -> attachment vertex: a scenario host name, or
    a raw ``vertex:N``."""
    if name is None:
        raise ValueError("link fault requires src= and dst=")
    if name.startswith("vertex:"):
        return int(name[len("vertex:"):])
    if name not in name_to_idx:
        raise ValueError(f"fault names unknown host {name!r}")
    return int(vertex[name_to_idx[name]])


def compile_faults(specs, name_to_idx: dict, vertex, topo=None,
                   stop_time: int = None):
    """FaultSpec list -> time-sorted FaultEvent schedule. Bad kinds and
    targets raise; faults at or after the stop time and link faults
    between vertices with no direct edge warn."""
    events = []
    eid = 0
    for seq, f in enumerate(specs):
        t = int(f.at)
        if stop_time is not None and t >= stop_time:
            sys.stderr.write(
                f"shadow_tpu_torch: warning: fault #{seq} ({f.kind}) at "
                f"{t}ns is at/after the stop time and never fires\n")
        if f.kind in HOST_KINDS:
            if f.host is None or f.host not in name_to_idx:
                raise ValueError(
                    f"fault #{seq} ({f.kind}) needs host=<scenario "
                    f"host name>, got {f.host!r}")
            events.append(FaultEvent(t=t, seq=seq, kind=f.kind,
                                     host=name_to_idx[f.host]))
            if f.kind == "host_down" and f.until is not None:
                if int(f.until) <= t:
                    raise ValueError(
                        f"fault #{seq}: host_down episode needs "
                        "until > at")
                events.append(FaultEvent(t=int(f.until), seq=seq,
                                         kind="host_up",
                                         host=name_to_idx[f.host]))
            continue
        if f.kind not in LINK_KINDS:
            raise ValueError(
                f"fault #{seq}: unknown kind {f.kind!r} "
                f"(have: {HOST_KINDS + LINK_KINDS})")
        va = _resolve_endpoint(f.src, name_to_idx, vertex)
        vb = _resolve_endpoint(f.dst, name_to_idx, vertex)
        if topo is not None and not topo.has_edge(va, vb):
            sys.stderr.write(
                f"shadow_tpu_torch: warning: fault #{seq} ({f.kind}) "
                f"names vertices {va}<->{vb} with no direct edge; it "
                "applies to that PATH entry only, not to routes "
                "through it\n")
        if f.kind == "link_down":
            events.append(FaultEvent(t=t, seq=seq, kind="link_down",
                                     va=va, vb=vb, eid=eid))
            if f.until is not None:
                if int(f.until) <= t:
                    raise ValueError(
                        f"fault #{seq}: link_down episode needs "
                        "until > at")
                events.append(FaultEvent(t=int(f.until), seq=seq,
                                         kind="link_up", va=va, vb=vb,
                                         eid=eid))
        elif f.kind == "link_up":
            events.append(FaultEvent(t=t, seq=seq, kind="link_up",
                                     va=va, vb=vb, eid=-1))
        elif f.kind == "loss":
            if not (0.0 < f.rate <= 1.0):
                raise ValueError(
                    f"fault #{seq}: loss needs 0 < rate <= 1, "
                    f"got {f.rate}")
            if f.until is None or int(f.until) <= t:
                raise ValueError(
                    f"fault #{seq}: loss episode needs until > at")
            events.append(FaultEvent(t=t, seq=seq, kind="loss_begin",
                                     va=va, vb=vb, eid=eid,
                                     rate=float(f.rate)))
            events.append(FaultEvent(t=int(f.until), seq=seq,
                                     kind="loss_end", eid=eid))
        elif f.kind == "latency":
            if f.extra_ns <= 0:
                raise ValueError(
                    f"fault #{seq}: latency episode needs extra > 0 "
                    "(only ADDED latency preserves the lookahead "
                    "window's causality bound)")
            if f.until is None or int(f.until) <= t:
                raise ValueError(
                    f"fault #{seq}: latency episode needs until > at")
            events.append(FaultEvent(t=t, seq=seq, kind="lat_begin",
                                     va=va, vb=vb, eid=eid,
                                     extra_ns=int(f.extra_ns)))
            events.append(FaultEvent(t=int(f.until), seq=seq,
                                     kind="lat_end", eid=eid))
        eid += 1
    events.sort(key=lambda e: (e.t, e.seq, e.kind))
    return events


class _HostsEditor:
    """Numpy copies of the Hosts fields a fault batch touches, pulled
    on first touch and written back in place by flush()."""

    def __init__(self, hosts):
        self._hosts = hosts
        self._arrs = {}

    def __getitem__(self, field: str) -> np.ndarray:
        a = self._arrs.get(field)
        if a is None:
            a = getattr(self._hosts, field).cpu().numpy().copy()
            self._arrs[field] = a
        return a

    def flush(self):
        for f, a in self._arrs.items():
            t = getattr(self._hosts, f)
            t.copy_(torch.from_numpy(a).to(t.device))
        self._arrs = {}


class FaultInjector:
    """Executes a compiled fault schedule against live state. The run
    loop asks next_time() to bound each segment and calls apply_batch()
    when the engine reaches a fault time."""

    # socket columns scrubbed on host_down (sock_alloc reinitializes a
    # row fully when it is claimed again)
    _SK_SCRUB = (("sk_used", False), ("sk_proto", 0),
                 ("sk_state", TCPS_CLOSED), ("sk_ctl", 0),
                 ("sk_timer_on", False), ("sk_rto_deadline", 0),
                 ("sk_lport", 0), ("sk_rport", 0), ("sk_rhost", -1),
                 ("sk_parent", -1), ("sk_close_after", False),
                 ("sk_app_ref", -1))

    def __init__(self, events, base_lat_ns, base_rel, vertex,
                 procs_of_host: dict, host_names):
        self.events = list(events)
        self.i = 0
        self.base_lat = np.array(base_lat_ns, dtype=np.int64)
        self.base_rel = np.array(base_rel, dtype=np.float32)
        self.vertex = np.asarray(vertex)
        self.procs_of_host = procs_of_host  # hid -> [proc slots]
        self.host_names = list(host_names)
        self.hosting = None     # the Simulation's HostingRuntime, if any
        self.links_down = {}         # (va, vb) sorted pair -> down count
        self.loss_eps = {}           # eid -> (va, vb, rate)
        self.lat_eps = {}            # eid -> (va, vb, extra_ns)
        self.log = []                # applied-fault records (SimReport)
        self.rsts = 0                # RSTs radiated by host_down
        # the effective latency table, which times host_down's RSTs
        self._cur_lat = self.base_lat

    def pending(self) -> bool:
        return self.i < len(self.events)

    def next_time(self):
        """Earliest unapplied fault time, or None."""
        return self.events[self.i].t if self.pending() else None

    def fast_forward(self, idx: int, sh):
        """Re-arm at schedule position `idx` (a checkpoint's
        ``__fault_idx__``): host faults already live in the restored
        state; the link-episode bookkeeping is replayed and the Shared
        tables rebuilt. Returns the (possibly rebuilt) Shared."""
        if not (0 <= idx <= len(self.events)):
            raise ValueError(
                f"checkpoint fault index {idx} is outside this "
                f"schedule (0..{len(self.events)}) — the snapshot "
                "belongs to a different fault config")
        dirty = False
        for ev in self.events[:idx]:
            if ev.kind not in HOST_KINDS:
                self._link_event(ev)
                dirty = True
            self.log.append(self._record(ev))
        self.i = idx
        return self._recompute_shared(sh) if dirty else sh

    def apply_batch(self, hosts, sh):
        """Apply every event sharing the head time: `hosts` is edited
        in place; returns the (possibly rebuilt) Shared."""
        assert self.pending()
        t = self.events[self.i].t
        ed = _HostsEditor(hosts)
        dirty = False
        while self.pending() and self.events[self.i].t == t:
            ev = self.events[self.i]
            self.i += 1
            if ev.kind == "host_down":
                self._host_down(ed, ev.host, t)
            elif ev.kind == "host_up":
                self._host_up(ed, ev.host, t)
            else:
                self._link_event(ev)
                dirty = True
            self.log.append(self._record(ev))
        ed.flush()
        return self._recompute_shared(sh) if dirty else sh

    def _record(self, ev: FaultEvent) -> dict:
        r = {"t": ev.t, "kind": ev.kind}
        if ev.host >= 0:
            r["host"] = self.host_names[ev.host]
        if ev.va >= 0:
            r["link"] = (int(ev.va), int(ev.vb))
        if ev.rate:
            r["rate"] = ev.rate
        if ev.extra_ns:
            r["extra_ns"] = ev.extra_ns
        return r

    # --- host faults ---
    def _host_down(self, ed: _HostsEditor, hid: int, t: int):
        """Power the host off: RST every established TCP connection
        toward its peer, then clear all volatile state."""
        sk_used = ed["sk_used"]
        sk_proto = ed["sk_proto"]
        sk_state = ed["sk_state"]
        sk_rhost = ed["sk_rhost"]
        for s in range(sk_used.shape[1]):
            if not sk_used[hid, s] or sk_proto[hid, s] != P.PROTO_TCP:
                continue
            st = int(sk_state[hid, s])
            if st < TCPS_ESTABLISHED or st == TCPS_TIME_WAIT:
                continue
            peer = int(sk_rhost[hid, s])
            if peer < 0 or peer == hid:
                continue          # a loopback peer dies with the host
            lat = int(self._cur_lat[self.vertex[hid],
                                    self.vertex[peer]])
            pkt = np.zeros(P.PKT_WORDS, np.int32)
            pkt[P.SRC] = hid
            pkt[P.DST] = peer
            pkt[P.SPORT] = ed["sk_lport"][hid, s]
            pkt[P.DPORT] = ed["sk_rport"][hid, s]
            pkt[P.FLAGS] = P.PROTO_TCP | P.F_RST
            self._push_event(ed, peer, t + lat, EV_PKT, pkt)
            self.rsts += 1
        if self.hosting is not None:
            self.hosting.kill_host(
                hid, cause=f"fault: host_down at t={t}ns", sim_ns=t)
        for f in ("eq_time", "eq_next"):
            ed[f][hid] = SIMTIME_MAX
        ed["eq_kind"][hid] = EV_NULL
        ed["ob_cnt"][hid] = 0
        ed["ob_next"][hid] = SIMTIME_MAX
        ed["txq_cnt"][hid] = 0
        ed["txq_head"][hid] = 0
        ed["nic_sched"][hid] = False
        ed["hw_cnt"][hid] = 0
        ed["app_node"][hid] = 0
        ed["app_r"][hid] = 0
        for f, val in self._SK_SCRUB:
            ed[f][hid] = val
        # no wake stamped for an earlier incarnation may match a later one
        ed["sk_timer_gen"][hid] += 1
        ed["stats"][hid, defs.ST_FAULTS] += 1

    def _host_up(self, ed: _HostsEditor, hid: int, t: int):
        """Re-arm the process start events (the boot sequence the
        Simulation pushes at build); a hosted app respawns fresh."""
        if self.hosting is not None:
            self.hosting.restart_host(hid)
        ed["app_node"][hid] = 0
        ed["app_r"][hid] = 0
        for p in self.procs_of_host.get(hid, ()):
            pkt = np.zeros(P.PKT_WORDS, np.int32)
            pkt[P.ACK] = WAKE_START
            pkt[P.SEQ] = -1
            pkt[P.SRC] = p        # slotless wake: process slot
            self._push_event(ed, hid, t, EV_APP, pkt)
        ed["stats"][hid, defs.ST_FAULTS] += 1

    def _push_event(self, ed: _HostsEditor, hid: int, when: int,
                    kind: int, pkt: np.ndarray):
        """equeue.q_push on one host row, in numpy."""
        eq_time = ed["eq_time"]
        free = np.flatnonzero(eq_time[hid] == SIMTIME_MAX)
        if free.size == 0:
            ed["stats"][hid, defs.ST_EQ_FULL_LOCAL] += 1
            return
        q = int(free[0])
        eq_time[hid, q] = when
        ed["eq_kind"][hid, q] = kind
        ed["eq_seq"][hid, q] = ed["eq_ctr"][hid]
        ed["eq_ctr"][hid] += 1
        ed["eq_pkt"][hid, q] = pkt
        ed["eq_next"][hid] = min(int(ed["eq_next"][hid]), when)

    # --- link faults ---
    def _link_event(self, ev: FaultEvent):
        if ev.kind == "link_down":
            key = (min(ev.va, ev.vb), max(ev.va, ev.vb))
            self.links_down[key] = self.links_down.get(key, 0) + 1
        elif ev.kind == "link_up":
            key = (min(ev.va, ev.vb), max(ev.va, ev.vb))
            n = self.links_down.get(key, 0) - 1
            if n > 0:
                self.links_down[key] = n
            else:
                self.links_down.pop(key, None)
        elif ev.kind == "loss_begin":
            self.loss_eps[ev.eid] = (ev.va, ev.vb, ev.rate)
        elif ev.kind == "loss_end":
            self.loss_eps.pop(ev.eid, None)
        elif ev.kind == "lat_begin":
            self.lat_eps[ev.eid] = (ev.va, ev.vb, ev.extra_ns)
        elif ev.kind == "lat_end":
            self.lat_eps.pop(ev.eid, None)

    def _recompute_shared(self, sh):
        """Shared with lat/rel rebuilt from the pristine base plus the
        active episodes (float32 products in the reference's order)."""
        lat = self.base_lat.copy()
        rel = self.base_rel.copy()
        for eid in sorted(self.lat_eps):
            va, vb, extra = self.lat_eps[eid]
            lat[va, vb] += extra
            if va != vb:
                lat[vb, va] += extra
        for eid in sorted(self.loss_eps):
            va, vb, rate = self.loss_eps[eid]
            rel[va, vb] *= (1.0 - rate)
            if va != vb:
                rel[vb, va] *= (1.0 - rate)
        for va, vb in sorted(self.links_down):
            rel[va, vb] = 0.0
            if va != vb:
                rel[vb, va] = 0.0
        self._cur_lat = lat
        dev = sh.lat_ns.device
        return dataclasses.replace(
            sh, lat_ns=torch.as_tensor(lat, dtype=torch.int64, device=dev),
            rel=torch.as_tensor(rel, dtype=torch.float32, device=dev))


class CrashHook:
    """Simulator-suicide triggers for durability tests: SIGKILL this
    process at the first chunk boundary at or after a simulated time,
    or after a wall-clock delay. Environment:

    - ``SHADOW_TPU_CRASH_SIM_NS``: fire when the run loop first sees
      ``ws >= value`` (after the checkpoint block);
    - ``SHADOW_TPU_CRASH_WALL_S``: fire after this many wall seconds;
    - ``SHADOW_TPU_CRASH_GUARD``: a path created O_EXCL when firing, so
      a supervised resume of the same command line does not crash again.
    """

    def __init__(self, sim_ns: int = None, wall_s: float = None,
                 guard: str = None):
        self.sim_ns = sim_ns
        self.guard = guard
        self._timer = None
        if wall_s is not None:
            import threading
            self._timer = threading.Timer(wall_s, self._fire)
            self._timer.daemon = True
            self._timer.start()

    @classmethod
    def from_env(cls):
        import os as _os
        sim_ns = _os.environ.get("SHADOW_TPU_CRASH_SIM_NS")
        wall_s = _os.environ.get("SHADOW_TPU_CRASH_WALL_S")
        if not sim_ns and not wall_s:
            return None
        return cls(sim_ns=int(sim_ns) if sim_ns else None,
                   wall_s=float(wall_s) if wall_s else None,
                   guard=_os.environ.get("SHADOW_TPU_CRASH_GUARD"))

    def _fire(self):
        import os as _os
        import signal as _signal
        if self.guard:
            try:
                fd = _os.open(self.guard,
                              _os.O_CREAT | _os.O_EXCL | _os.O_WRONLY)
                _os.close(fd)
            except FileExistsError:
                self.sim_ns = None          # already fired once: disarm
                if self._timer is not None:
                    self._timer.cancel()
                return
            except OSError as e:
                # a broken guard must not skip the kill silently
                sys.stderr.write(
                    f"shadow_tpu_torch: CrashHook guard {self.guard!r} "
                    f"unusable ({e}) — firing without fire-once "
                    "protection\n")
        sys.stderr.write(
            "shadow_tpu_torch: CrashHook firing — SIGKILLing the "
            "simulator (durability test)\n")
        sys.stderr.flush()
        _os.kill(_os.getpid(), _signal.SIGKILL)

    def maybe_fire(self, ws: int):
        """Run-loop check for the sim-time trigger."""
        if self.sim_ns is not None and ws >= self.sim_ns:
            self._fire()
