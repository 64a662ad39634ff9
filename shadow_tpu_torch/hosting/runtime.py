"""CPU half of the hosting bridge: drain wakes, run app code, batch ops.

Counterpart of ``shadow_tpu/hosting/runtime.py``. Drives hosted apps
between lookahead windows, on the port's tensors in place. The dispatch
order is deterministic: wake records sort by (time, host, ring index)
before delivery, and per-host RNG streams are seeded from the scenario seed —
the same guarantees the reference's deterministic scheduler provides to
plugins (SURVEY §4 determinism tests).
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..engine.defs import (WAKE_START, WAKE_TIMER, WAKE_SOCKET,
                           WAKE_CONNECTED, WAKE_EOF, WAKE_ACCEPT, WAKE_SENT)
from ..net import packet as P
from ..obs import digest as _DG
from .api import HostOS
from .bridge import OP_WORDS, apply_ops

# first link of the hosted op-stream digest chain (see _op_chain)
OPS_CHAIN_SEED = hashlib.blake2b(
    b"shadow_tpu.hosted.ops.v1", digest_size=8).hexdigest()


class HostingRuntime:
    """Owns the hosted app instances and the window-boundary exchange."""

    def __init__(self, apps: dict, names: dict, dns, seed: int,
                 batch_cap: int = 256, procs: dict = None,
                 factories: dict = None):
        # apps: host_id -> HostedApp; names: host_id -> hostname;
        # procs: host_id -> the hosted process's slot on its host
        # (0 when the hosted app is the only process — the op replay
        # stamps it so sockets wake the hosted slot, not process 0);
        # factories: host_id -> zero-arg callable producing a FRESH
        # app instance (fault-injection restarts respawn through it)
        self.apps = apps
        self.procs = procs or {}
        self.factories = factories or {}
        self.names = names
        self.batch_cap = batch_cap
        self._dns = dns
        self._now = 0
        self._journal_on = False    # enable_journal(): checkpoint runs
        #   journal each child's protocol stream for resume replay
        # hosted-channel op-stream digest (obs.digest): a rolling
        # CHAIN hash over every applied op batch — with the per-app
        # shim request digests it attributes a determinism divergence
        # to the hosted tier. A chain (hash of previous hex + batch)
        # rather than one long hash object so checkpoints can carry it
        # (hashlib midstates do not pickle). Updated only while a
        # digest recorder is installed.
        self._op_chain = OPS_CHAIN_SEED
        self._dead = set()      # generic apps killed by a fault (shim
        #   apps self-guard; these need their wakes suppressed here)
        self._exit_log = {}     # host_id -> exit record of the LAST
        #   death (a restarted-and-surviving child leaves no record)
        # one per-simulation payload broker (api.PayloadBroker): hosted
        # apps that move REAL bytes (the LD_PRELOAD shim) share it so
        # hosted<->hosted TCP connections deliver actual payloads
        from .api import PayloadBroker
        self.payloads = PayloadBroker()
        for app in apps.values():
            attach = getattr(app, "attach_payload_broker", None)
            if attach is not None:
                attach(self.payloads)
        self.os = {
            hid: HostOS(hid, names.get(hid, f"host{hid}"),
                        np.random.default_rng((seed, hid)), dns,
                        lambda: self._now)
            for hid in apps
        }

    def shutdown(self):
        """End-of-run teardown: release apps holding OS resources
        (e.g. the LD_PRELOAD shim's child process) — a stop_time
        truncation otherwise leaks them."""
        for app in self.apps.values():
            terminate = getattr(app, "terminate", None)
            if terminate is not None:
                terminate()

    def has_hosts(self) -> bool:
        return bool(self.apps)

    # --- supervision / fault-injection surface (engine.faults) ---
    def kill_host(self, hid: int, cause: str, sim_ns: int):
        """host_down: SIGKILL a shim child (ShimApp.fault_kill records
        the cause); a pure-Python hosted app just stops receiving
        wakes. The injector scrubs the device state itself."""
        app = self.apps.get(hid)
        if app is None:
            return
        fk = getattr(app, "fault_kill", None)
        if fk is not None:
            fk(cause, sim_ns)
        else:
            self._dead.add(hid)
            self._exit_log[hid] = {"exit_status": None, "cause": cause,
                                   "sim_ns": sim_ns, "clean": False,
                                   "violations": []}

    def restart_host(self, hid: int):
        """host_up: archive the dead instance's exit record and swap
        in a FRESH app from its factory (a shim app respawns its child
        on the WAKE_START the injector re-arms). The HostOS — and with
        it the per-host RNG stream — carries over: the restarted
        process continues the host's deterministic entropy sequence."""
        old = self.apps.get(hid)
        if old is not None:
            # a host_up with no preceding host_down replaces a LIVE
            # instance: reap its child/channel first or the orphan
            # process outlives the simulation (end-of-run shutdown
            # only walks the current apps)
            fk = getattr(old, "fault_kill", None)
            if fk is not None:
                fk("fault: host_up replaced the live instance", None)
            info = getattr(old, "exit_info", None)
            rec = info() if info is not None else None
            if rec is not None:
                self._exit_log[hid] = rec
        factory = self.factories.get(hid)
        if factory is None:
            self._dead.discard(hid)
            return
        app = factory()
        attach = getattr(app, "attach_payload_broker", None)
        if attach is not None:
            attach(self.payloads)
        if self._journal_on:
            ej = getattr(app, "enable_journal", None)
            if ej is not None:
                ej()
        self.apps[hid] = app
        self._dead.discard(hid)

    # --- checkpoint/resume (engine.checkpoint hosted sidecar) ---
    def enable_journal(self):
        """Checkpointed runs journal each shim child's protocol
        stream so a resume can fast-forward a respawned child by
        deterministic replay (docs/durability.md). Must be enabled
        before children spawn (engine.sim does, before the run loop).
        The journal grows with the child's syscall traffic for the
        whole run — the documented price of hosted resumability."""
        self._journal_on = True
        for app in self.apps.values():
            ej = getattr(app, "enable_journal", None)
            if ej is not None:
                ej()

    def snapshot(self) -> bytes:
        """Pickle the hosted tier for one checkpoint: app instances
        (ShimApp excludes its live process/channel and keeps the
        journal), per-host OS state (PRNG + live socket handles — ONE
        pickle, so Sock identity shared between HostOS and app state
        survives), the payload broker, and the op-stream chain.
        Runs at a window boundary: every pending op batch has been
        flushed and every live child is parked in a blocked call."""
        import pickle
        for os_ in self.os.values():
            assert not os_._ops, \
                "hosted snapshot mid-batch (ops not flushed)"
        state = {
            "version": 1,
            "op_chain": self._op_chain,
            "dead": set(self._dead),
            "exit_log": dict(self._exit_log),
            "payload_streams": self.payloads._streams,
            "payload_subs": self.payloads._subs,
            "apps": dict(self.apps),
            "os": {hid: {"rng": o._rng, "socks": o._socks}
                   for hid, o in self.os.items()},
        }
        try:
            return pickle.dumps(state,
                                protocol=pickle.HIGHEST_PROTOCOL)
        except Exception as e:
            raise RuntimeError(
                "hosted tier is not snapshotable: a hosted app holds "
                f"unpicklable state ({type(e).__name__}: {e}); give "
                "it __getstate__/__setstate__ like hosting.shim."
                "ShimApp") from e

    def restore(self, blob: bytes):
        """Rebuild the hosted tier from a checkpoint sidecar, then
        fast-forward each shim child by replaying its journaled
        protocol stream (ShimApp.resume_replay): the respawned binary
        re-executes deterministically (time, entropy and I/O are
        virtualized), re-issues the same requests, and receives the
        journaled responses — byte divergence is diagnosed loudly in
        SimReport.hosted and the child is killed, never desynced."""
        import pickle
        state = pickle.loads(blob)
        self._op_chain = state["op_chain"]
        self._dead = state["dead"]
        self._exit_log = state["exit_log"]
        self.payloads._streams = state["payload_streams"]
        self.payloads._subs = state["payload_subs"]
        self.apps = state["apps"]
        self.os = {}
        for hid, osd in state["os"].items():
            o = HostOS(hid, self.names.get(hid, f"host{hid}"),
                       osd["rng"], self._dns, lambda: self._now)
            o._socks = osd["socks"]
            self.os[hid] = o
        for hid, app in sorted(self.apps.items()):
            attach = getattr(app, "attach_payload_broker", None)
            if attach is not None:
                attach(self.payloads)
            if self._journal_on:
                ej = getattr(app, "enable_journal", None)
                if ej is not None:
                    ej()
        # replay AFTER the whole tier is rewired (a replaying child's
        # payload pops must see the restored broker)
        for hid, app in sorted(self.apps.items()):
            rr = getattr(app, "resume_replay", None)
            if rr is not None:
                rr(self.os[hid])
        if not self._journal_on:
            # this run takes no further snapshots, so the restored
            # journals have no consumer left — drop them instead of
            # buffering the rest of the run's traffic
            for app in self.apps.values():
                dj = getattr(app, "disable_journal", None)
                if dj is not None:
                    dj()

    def exit_info(self) -> dict:
        """Per-host exit report, keyed by hostname (SimReport.hosted):
        the latest death of each hosted process, including children
        reaped at end-of-run shutdown."""
        out = {}
        for hid, app in sorted(self.apps.items()):
            rec = None
            info = getattr(app, "exit_info", None)
            if info is not None:
                rec = info()
            if rec is None:
                rec = self._exit_log.get(hid)
            if rec is not None:
                out[self.names.get(hid, f"host{hid}")] = rec
        return out

    def digest_state(self) -> dict:
        """Hosted-tier digests for one obs.digest record: the running
        op-batch stream hash plus each shim app's protocol-request
        stream hash (hostname-keyed — stable across runs)."""
        out = {"ops": self._op_chain}
        shim = {}
        for hid, app in sorted(self.apps.items()):
            f = getattr(app, "op_stream_digest", None)
            if f is not None:
                shim[self.names.get(hid, f"host{hid}")] = f()
        if shim:
            out["shim"] = shim
        return out

    def child_rss(self) -> dict:
        """host_id -> resident-set bytes of live hosted children (the
        [ram] tracker heartbeat column; obs.tracker)."""
        out = {}
        for hid, app in self.apps.items():
            rss = getattr(app, "rss_bytes", None)
            if rss is not None:
                v = rss()
                if v is not None:
                    out[hid] = v
        return out

    def step(self, st, hp, sh, now_ns: int):
        """Drain the wake rings of `st` (a port Hosts), dispatch the app
        callbacks and apply their op batch, in place."""
        hw_cnt = st.hw_cnt.cpu().numpy()
        if not hw_cnt.any():
            return
        hw_time = st.hw_time.cpu().numpy()
        hw_pkt = st.hw_pkt.cpu().numpy()

        # deterministic delivery order: (time, host, ring index)
        recs = []
        for hid in np.flatnonzero(hw_cnt):
            for i in range(int(hw_cnt[hid])):
                recs.append((int(hw_time[hid, i]), int(hid), i))
        recs.sort()

        for t, hid, i in recs:
            app = self.apps.get(hid)
            if app is None or hid in self._dead:
                continue
            os = self.os[hid]
            self._now = t
            wake = hw_pkt[hid, i]
            reason = int(wake[P.ACK])
            slot = int(wake[P.SEQ])
            gen = int(wake[P.WND]) & 0x7FFF
            sock = os.sock_for(slot, gen) if slot >= 0 else None
            if reason == WAKE_START:
                app.on_start(os)
            elif reason == WAKE_TIMER:
                app.on_timer(os, int(wake[P.AUX]))
            elif reason == WAKE_CONNECTED:
                # the connected wake rides the SYN|ACK: SRC/SPORT are
                # the server's identity, DPORT our local ephemeral port
                app.on_connected(os, sock,
                                 lport=int(wake[P.DPORT]),
                                 peer=(int(wake[P.SRC]),
                                       int(wake[P.SPORT])))
            elif reason == WAKE_ACCEPT:
                # the accept wake rides the SYN packet: SRC/SPORT are
                # the connecting client's identity, DPORT the listener
                app.on_accept(os, sock, int(wake[P.APP]),
                              dport=int(wake[P.DPORT]),
                              peer=(int(wake[P.SRC]),
                                    int(wake[P.SPORT])))
            elif reason == WAKE_EOF:
                app.on_eof(os, sock)
            elif reason == WAKE_SENT:
                app.on_sent(os, sock)
            elif reason == WAKE_SOCKET:
                app.on_dgram(os, sock, int(wake[P.SRC]), int(wake[P.SPORT]),
                             int(wake[P.LEN]), int(wake[P.AUX]))

        self._now = now_ns
        self._flush(st, hp, sh)

    def _flush(self, st, hp, sh):
        """Apply all pending ops as one batch and bind returned socket
        slots to their Sock handles. Operands that are still-unresolved
        Socks from this batch are encoded as result references
        (-(k+2) for op k), decoded on device — create-before-use holds
        because each host's ops keep insertion order."""
        from .api import Sock

        pending = []  # (hid, os, op) in deterministic host order
        for hid in sorted(self.os):
            os = self.os[hid]
            for op in os._ops:
                pending.append((hid, os, op))
            os._ops = []

        if not pending:
            # nothing to apply: just clear the drained wake rings
            st.hw_cnt.zero_()
            return

        ops = np.zeros((len(pending), OP_WORDS), dtype=np.int64)
        ref_of = {}  # Sock object -> creating op index
        for k, (hid, os, op) in enumerate(pending):
            if op.out is not None and not isinstance(op.out, tuple):
                ref_of[id(op.out)] = k   # pipe pairs (tuples) cannot
                # be same-batch referenced: one result names two socks

            def enc(x):
                if isinstance(x, Sock):
                    j = ref_of.get(id(x))
                    if j is None:
                        raise RuntimeError(
                            "Sock used before any op created it")
                    return -(j + 2)
                return int(x)

            ops[k] = (hid, op.code, enc(op.a), enc(op.b), enc(op.c),
                      enc(op.d), op.t, self.procs.get(hid, 0))
        if _DG.ENABLED:
            # the batch IS the hosted-channel op stream the device
            # replays — chain-hash it in flush order
            self._op_chain = hashlib.blake2b(
                bytes.fromhex(self._op_chain) + ops.tobytes(),
                digest_size=8).hexdigest()
        res = apply_ops(st, hp, sh, ops)
        for k, (hid, os, op) in enumerate(pending):
            if isinstance(op.out, tuple):
                os._bind_pipe(op.out[0], op.out[1], int(res[k]))
            elif op.out is not None:
                os._bind(op.out, int(res[k]))
