"""Fleet pre-warm: build and capture each distinct shape once, up front.

Counterpart of ``shadow_tpu/serving/prewarm.py``. A sweep's runs
mostly share a handful of shapes. Without this module every worker
child finds out the slow way: it builds the native kernel library
(serving.aotcache) if no earlier child has, and captures its chunk
graph (core.jitcache). With ``fleet run --prewarm --aot-cache DIR`` the
scheduler instead:

1. **fingerprints** each queued config run's shape headlessly (a cheap
   ``--shape-fingerprint`` child per run: builds the Simulation and
   prints the config fingerprint and chunk, never runs);
2. **dedups** shapes across the sweep;
3. **warms each distinct shape once** in a pre-warm slot (a
   ``--prewarm --aot-cache DIR`` child that builds or loads the library
   into the shared disk tier, captures the chunk graph and exits),
   before — or concurrently with — admission: a run is admitted only
   once its shape is warmed (or its warm FAILED, in which case it runs
   anyway and builds for itself — pre-warm is an optimization, never a
   gate that can wedge a sweep).

A captured graph cannot outlive its child, so what a worker finds warm
is the disk tier; the warm child's capture proves the shape captures.
Every transition journals into the queue (``{"op": "prewarm", ...}``),
so ``fleet status`` reports shapes warmed vs pending offline, and a
restarted scheduler re-probes cheaply.

The probe/warm child command builders are injectable so the
scheduler machinery tests need no card (tests/test_torch_aotcache.py).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def probe_argv(python: str, spec: dict) -> list:
    """The shape-fingerprint child for one config run spec: the same
    config, extra args and device a worker attempt would run (anything
    that changes the shape — --engine-caps, --seed, the digest cadence
    that shrinks the chunk — must be in both), ending in
    --shape-fingerprint."""
    argv = ([python or sys.executable, "-m", "shadow_tpu_torch",
             os.path.abspath(spec["config"])]
            + list(spec.get("args") or [])
            + ["--device", spec.get("device") or "cuda"])
    if spec.get("digest", True):
        # the worker child runs with --digest, whose cadence sets the
        # chunk; the probe must report THAT chunk's shape
        argv += ["--digest", "unused.probe.jsonl"]
        if spec.get("digest_every"):
            argv += ["--digest-every", str(spec["digest_every"])]
    return argv + ["--shape-fingerprint"]


def warm_argv(python: str, spec: dict, cache_dir: str) -> list:
    """The pre-warm child for one shape, built from a representative
    member spec. Digest settings ride along because the worker child
    will run with --digest, and the digest cadence sets the chunk the
    graph is captured for (engine.sim); the chain file itself is never
    written in --prewarm mode."""
    argv = ([python or sys.executable, "-m", "shadow_tpu_torch",
             os.path.abspath(spec["config"])]
            + list(spec.get("args") or [])
            + ["--device", spec.get("device") or "cuda",
               "--aot-cache", os.path.abspath(cache_dir), "--prewarm"])
    if spec.get("digest", True):
        argv += ["--digest", "unused.prewarm.jsonl"]
        if spec.get("digest_every"):
            argv += ["--digest-every", str(spec["digest_every"])]
    return argv


class Prewarmer:
    """Owns the probe → dedup → warm pipeline for one scheduler run.

    Non-blocking: the scheduler calls :meth:`tick` once per drain
    loop; :meth:`ready` gates admission. `journal` is a callback
    (op fields -> None) appending ``prewarm`` records to the queue
    journal; `probe_fn`/`warm_fn` build child argvs (injectable for
    tests without a card)."""

    def __init__(self, specs: list, cache_dir: str, python: str = None,
                 jobs: int = 1, log=None, journal=None,
                 probe_fn=probe_argv, warm_fn=warm_argv,
                 probe_timeout_s: float = 600.0,
                 warm_timeout_s: float = 3600.0):
        self.cache_dir = cache_dir
        self.python = python
        self.jobs = max(int(jobs), 1)
        # a hung probe/warm child must never wedge the sweep (the
        # scheduler-watchdog contract, one level down): past its
        # deadline it is SIGKILLed and counted failed — its runs
        # then admit and build for themselves
        self.probe_timeout_s = float(probe_timeout_s)
        self.warm_timeout_s = float(warm_timeout_s)
        self._deadline = {}      # id(proc) -> wall deadline
        self.log = log or (lambda m: sys.stderr.write(
            f"shadow_tpu_torch: prewarm: {m}\n"))
        self.journal = journal or (lambda **kw: None)
        self.probe_fn = probe_fn
        self.warm_fn = warm_fn
        # config-mode specs only; everything else is ready by
        # definition (cmd runs own their whole argv)
        self._specs = {s["id"]: s for s in specs if s.get("config")}
        self._to_probe = list(self._specs)
        self._probes = {}        # run_id -> Popen
        self._shape_of = {}      # run_id -> fingerprint or "" (failed)
        self._spec_of_shape = {}  # fingerprint -> representative spec
        self._to_warm = []       # fingerprints awaiting a warm slot
        self._warming = {}       # fingerprint -> Popen
        self._state = {}         # fingerprint -> warming|warmed|failed

    @staticmethod
    def _child_env(spec: dict) -> dict:
        """Probe/warm children run under the run's OWN environment
        overrides (``fleet submit --env``, e.g. a platform pin) — the
        worker attempt applies them (fleet.worker.Slot), so a
        probe/warm under the scheduler's environment could
        fingerprint and warm a different shape, paying a useless warm
        plus the run's own build."""
        env = dict(os.environ)
        env.update(spec.get("env") or {})
        return env

    # --- queries ----------------------------------------------------
    def ready(self, run_id: str) -> bool:
        """Admission gate: True once the run's shape is warmed — or
        its probe/warm FAILED (the run then builds for itself; a
        broken pre-warm must never starve the queue)."""
        if run_id not in self._specs:
            return True
        fp = self._shape_of.get(run_id)
        if fp is None:
            return False                  # probe still pending
        if fp == "":
            return True                   # probe failed: run anyway
        return self._state.get(fp) in ("warmed", "failed")

    def done(self) -> bool:
        return (not self._to_probe and not self._probes
                and not self._to_warm and not self._warming)

    def counts(self) -> dict:
        pending = sum(1 for fp, st in self._state.items()
                      if st == "warming") + len(self._to_warm)
        return {"warmed": sum(1 for s in self._state.values()
                              if s == "warmed"),
                "failed": sum(1 for s in self._state.values()
                              if s == "failed"),
                "warming": pending,
                "probing": len(self._to_probe) + len(self._probes)}

    # --- the pipeline -----------------------------------------------
    def tick(self):
        """Advance the pipeline without blocking: reap finished
        probe/warm children, launch new ones up to `jobs` each."""
        self._reap_probes()
        self._reap_warms()
        while self._to_probe and len(self._probes) < self.jobs:
            rid = self._to_probe.pop(0)
            spec = self._specs[rid]
            try:
                proc = subprocess.Popen(
                    self.probe_fn(self.python, spec),
                    stdout=subprocess.PIPE,
                    stderr=subprocess.DEVNULL,
                    env=self._child_env(spec))
            except OSError as e:
                self._probe_done(rid, "", f"spawn failed: {e}")
                continue
            self._probes[rid] = proc
            self._deadline[id(proc)] = (time.monotonic()
                                        + self.probe_timeout_s)
        while self._to_warm and len(self._warming) < self.jobs:
            fp = self._to_warm.pop(0)
            spec = self._spec_of_shape[fp]
            try:
                proc = subprocess.Popen(
                    self.warm_fn(self.python, spec, self.cache_dir),
                    stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL,
                    env=self._child_env(spec))
            except OSError as e:
                self._warm_done(fp, None, f"spawn failed: {e}")
                continue
            self._warming[fp] = proc
            self._deadline[id(proc)] = (time.monotonic()
                                        + self.warm_timeout_s)
            self._state[fp] = "warming"
            self.journal(shape=fp, state="warming",
                         run=spec["id"])
            self.log(f"shape {fp}: warming (via {spec['id']})")

    def _expired(self, proc) -> bool:
        dl = self._deadline.get(id(proc))
        if dl is None or time.monotonic() < dl:
            return False
        try:
            proc.kill()
        except OSError:
            pass
        return True

    def _reap_probes(self):
        for rid, proc in list(self._probes.items()):
            rc = proc.poll()
            if rc is None:
                if not self._expired(proc):
                    continue
                rc = proc.wait()
            del self._probes[rid]
            self._deadline.pop(id(proc), None)
            out = proc.stdout.read() if proc.stdout else b""
            if proc.stdout:
                proc.stdout.close()
            fp = ""
            if rc == 0:
                # the probe prints exactly one JSON line; scan for it
                # so a warning-spewing child still parses. `shape`
                # (chunk-qualified, c<chunk>.w<workers>.<fp>) is the
                # dedup key — two runs sharing a config fingerprint but
                # chunking differently capture different graphs; bare
                # `shape_fingerprint` is the fallback
                for line in out.decode(errors="replace").splitlines():
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if isinstance(rec, dict) and rec.get(
                            "shape_fingerprint"):
                        fp = (rec.get("shape")
                              or rec["shape_fingerprint"])
                        break
            self._probe_done(
                rid, fp,
                None if fp else f"probe rc={rc}, no fingerprint")

    def _probe_done(self, rid: str, fp: str, err: str = None):
        self._shape_of[rid] = fp
        if not fp:
            self.log(f"run {rid}: shape probe failed ({err}); the "
                     "run will build for itself")
            self.journal(shape="", state="probe-failed", run=rid)
            return
        self.journal(shape=fp, state="resolved", run=rid)
        if fp in self._state or fp in self._to_warm:
            return                         # deduped: already handled
        self._spec_of_shape[fp] = self._specs[rid]
        self._to_warm.append(fp)

    def _reap_warms(self):
        for fp, proc in list(self._warming.items()):
            rc = proc.poll()
            if rc is None:
                if not self._expired(proc):
                    continue
                rc = proc.wait()
            del self._warming[fp]
            self._deadline.pop(id(proc), None)
            self._warm_done(fp, rc)

    def shutdown(self):
        """Kill outstanding probe/warm children (scheduler exit or
        preemption): pre-warm is pure optimization, nothing durable
        is lost — a restarted scheduler re-probes, and warm children
        finding the library on disk exit in seconds."""
        for proc in list(self._probes.values()) + list(
                self._warming.values()):
            try:
                proc.kill()
                proc.wait(timeout=5)
            except Exception:
                pass
        self._probes.clear()
        self._warming.clear()
        self._to_probe.clear()
        self._to_warm.clear()

    def _warm_done(self, fp: str, rc, err: str = None):
        ok = rc == 0
        self._state[fp] = "warmed" if ok else "failed"
        self.journal(shape=fp, state=self._state[fp])
        if ok:
            self.log(f"shape {fp}: warmed")
        else:
            self.log(f"shape {fp}: pre-warm FAILED "
                     f"({err or f'rc={rc}'}); its runs will build "
                     "for themselves")
