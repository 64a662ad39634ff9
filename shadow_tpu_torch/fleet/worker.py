"""Worker slot: one run attempt as a supervised child process.

The single-run supervisor (engine.supervisor) re-execs ONE command
line until it completes; a fleet slot is the same idea held by the
scheduler: build the child CLI (managed durability args for config
runs — per-run checkpoint store, digest chain, ``--resume latest`` on
re-dispatch), spawn it in its own session (so a takeover can kill the
whole process group of an orphaned run), stream its stdout to the
run's log, and watch its wall-clock PROGRESS — checkpoint-pointer /
digest-chain / log mtimes — so a hung run is diagnosed and SIGKILLed
instead of wedging the slot (the shim watchdog contract, one level
up). Every exit is classified (engine.supervisor.classify_exit) and
appended to the run's crash-cause journal.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

from ..engine.supervisor import EXIT_PREEMPTED, CrashLog, classify_exit
from .queue import Queue


# claim-gate wrapper: the spawned process execs the real child ONLY
# once the claim file names its own pid — so a scheduler SIGKILLed
# inside the spawn→claim window leaves a gate that times out and
# exits 75 on its own, never an untracked live orphan racing a
# re-dispatched attempt over the same run directory. (A SIGSTOP
# handshake cannot do this: stopping before exec deadlocks Popen's
# exec-errpipe read in the parent.)
_CLAIM_GATE = """\
import json, os, sys, time
claim, me, end = sys.argv[1], str(os.getpid()), time.time() + 30
ok = False
while not ok and time.time() < end:
    try:
        ok = str(json.load(open(claim)).get("pid")) == me
    except Exception:
        ok = False
    if not ok:
        time.sleep(0.01)
if not ok:
    sys.exit(75)
os.execvp(sys.argv[2], sys.argv[2:])
"""


# the disk tier's variable (serving.aotcache.ENV)
AOT_ENV = "SHADOW_TPU_TORCH_AOT_CACHE"

def build_child_argv(queue: Queue, spec: dict, resume: bool,
                     python: str = None, aot_cache: str = None) -> list:
    """The child command line for one attempt. Config runs get the
    managed durability args, the spec's ``--device`` and ``--aot-cache``
    when the scheduler serves one (serving.aotcache); cmd runs are
    verbatim (their retries re-run from scratch — the spec chose that
    mode; they get the cache through SHADOW_TPU_TORCH_AOT_CACHE in
    their environment)."""
    if spec.get("cmd"):
        return list(spec["cmd"])
    rid = spec["id"]
    argv = ([python or sys.executable, "-m", "shadow_tpu_torch",
             os.path.abspath(spec["config"])]
            + list(spec.get("args") or [])
            + ["--device", spec.get("device") or "cuda",
               "--checkpoint", os.path.abspath(queue.store_base(rid)),
               "--checkpoint-every", str(spec["checkpoint_every"])])
    if spec.get("digest", True):
        argv += ["--digest", os.path.abspath(queue.digest_path(rid))]
        if spec.get("digest_every"):
            argv += ["--digest-every", str(spec["digest_every"])]
    if spec.get("perf") is not None:
        argv += (["--perf", spec["perf"]] if spec["perf"]
                 else ["--perf"])
    if spec.get("netscope"):
        argv += ["--netscope",
                 os.path.abspath(queue.netscope_path(rid))]
    if aot_cache:
        argv += ["--aot-cache", os.path.abspath(aot_cache)]
    if resume:
        argv += ["--resume", "latest"]
    return argv


def _cfg_bytes(path: str) -> bytes | None:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def build_batch_argv(queue: Queue, specs: list,
                     python: str = None, aot_cache: str = None) -> list:
    """The ONE child command line executing a whole batch group
    (``python -m shadow_tpu_torch batch`` — serving.batch), on the
    first member's ``--device``:
    per-member digest chains land in each member's run directory via
    --digest-paths, exactly where an individual run's would. Two
    forms, decided by the specs: every member carrying a batch_seed
    = one XML x N seeds; otherwise one XML per member."""
    py = python or sys.executable
    seeds = [s.get("batch_seed") for s in specs]
    seeded = [sd is not None for sd in seeds]
    # backstop for the submit-time group-consistency gate (fleet.cli):
    # a malformed group must refuse here — the scheduler records the
    # OSError as a per-member spawn failure — never silently run the
    # wrong XML or drop seeds. OSError because that is the spawn-
    # failure contract the scheduler already handles.
    if any(seeded) and not all(seeded):
        raise OSError(
            "batch group mixes seeded and unseeded members — one "
            "child runs one argv shape (docs/serving.md); resubmit "
            "the group in one form")
    if all(seeded):
        if len(specs) > 1:
            blobs = {_cfg_bytes(s["config"]) for s in specs}
            blobs.discard(None)
            if len(blobs) > 1:
                raise OSError(
                    "batch group is the one-XML-many-seeds form but "
                    "its members' XMLs differ — seeded members all "
                    "run ONE config (docs/serving.md)")
        argv = [py, "-m", "shadow_tpu_torch", "batch",
                os.path.abspath(specs[0]["config"]),
                "--seeds", ",".join(str(sd) for sd in seeds)]
    else:
        argv = ([py, "-m", "shadow_tpu_torch", "batch"]
                + [os.path.abspath(s["config"]) for s in specs])
    argv += ["--device", specs[0].get("device") or "cuda"]
    if specs[0].get("digest", True):
        argv += ["--digest-paths",
                 ",".join(os.path.abspath(queue.digest_path(s["id"]))
                          for s in specs)]
        if specs[0].get("digest_every"):
            argv += ["--digest-every",
                     str(specs[0]["digest_every"])]
    if specs[0].get("perf") is not None:
        argv += (["--perf", specs[0]["perf"]] if specs[0]["perf"]
                 else ["--perf"])
    if specs[0].get("netscope"):
        # per-lane time-series land in each member's run directory,
        # exactly where an individual run's would (like the digest
        # chains above)
        argv += ["--netscope-paths",
                 ",".join(os.path.abspath(
                     queue.netscope_path(s["id"])) for s in specs)]
    if aot_cache:
        argv += ["--aot-cache", os.path.abspath(aot_cache)]
    return argv


class Slot:
    """One executing attempt. The scheduler polls it; it owns the
    child process, the claim's pid refresh, and the exit record."""

    def __init__(self, queue: Queue, state, python: str = None,
                 log=None, aot_cache: str = None):
        self.queue = queue
        self.spec = state.spec
        self.run_id = state.spec["id"]
        self.attempt = state.started + 1
        self.resume = bool(state.resume and state.spec.get("config"))
        self.log = log or (lambda m: sys.stderr.write(
            f"shadow_tpu_torch: fleet: {m}\n"))
        self.hung = False           # watchdog SIGKILLed it
        self.preempting = False     # we SIGTERMed it (scheduler preempt)
        self.preempt_killed = False  # grace expired -> SIGKILL
        self.crash_log = CrashLog(queue.crash_log_path(self.run_id))

        rd = queue.run_dir(self.run_id)
        os.makedirs(rd, exist_ok=True)
        argv = build_child_argv(queue, self.spec, self.resume, python,
                                aot_cache=aot_cache)
        env = dict(os.environ)
        env.update(self.spec.get("env") or {})
        env["SHADOW_TPU_FLEET_RUN_DIR"] = os.path.abspath(rd)
        if aot_cache:
            env[AOT_ENV] = os.path.abspath(aot_cache)
        self._stdout = open(queue.log_path(self.run_id), "ab")
        self.t0 = time.time()
        self.last_progress = self.t0
        # own session (killpg-able takeover), gated behind the claim:
        # the wrapper execs the real argv only once the claim names
        # its pid (start() publishes it); exec failures of a bad
        # executable surface as a crash exit in run.log
        try:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", _CLAIM_GATE,
                 os.path.abspath(queue.claim_path(self.run_id))] + argv,
                stdout=self._stdout, stderr=subprocess.STDOUT,
                env=env, start_new_session=True)
        except OSError:
            self._stdout.close()       # no slot survives to close it
            raise
        self.argv = argv          # the REAL child argv (claims,
        #   crash records, recovery cmdline match — post-exec the
        #   process's /proc cmdline equals exactly this)

    def start(self):
        """Open the claim gate: publish the claim with the child pid.
        If the claim cannot be written, kill the gate — it would time
        out and exit 75 on its own anyway."""
        try:
            self.refresh_claim()
        except OSError:
            self.kill()
            raise

    # --- claim pid refresh (recovery needs the CHILD pid) ---
    def claim_meta(self) -> dict:
        return {"scheduler_pid": os.getpid(), "pid": self.proc.pid,
                "attempt": self.attempt, "argv": self.argv}

    def refresh_claim(self):
        """Re-publish the claim with the child pid (the claim was
        taken before the pid existed): atomic replace, so a reader
        always sees a complete claim."""
        import json
        path = self.queue.claim_path(self.run_id)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"t": round(time.time(), 3),
                       **self.claim_meta()}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    # --- progress / watchdog ---
    def progress_paths(self) -> list:
        q, rid = self.queue, self.run_id
        # heartbeat FIRST: checkpoints/digests are sim-paced (a slow
        # box legitimately goes long wall stretches without either),
        # but engine.sim touches <run_dir>/heartbeat once per chunk
        # whenever SHADOW_TPU_FLEET_RUN_DIR is set — the wall-paced
        # liveness signal the watchdog actually needs
        return [os.path.join(q.run_dir(rid), "heartbeat"),
                q.store_base(rid) + ".latest", q.digest_path(rid),
                q.log_path(rid)]

    def check_progress(self) -> float:
        """Newest progress timestamp: spawn time or the latest mtime
        of the run's checkpoint pointer / digest chain / stdout log —
        the signals a LIVE run refreshes and a hung one cannot."""
        for p in self.progress_paths():
            try:
                m = os.path.getmtime(p)
            except OSError:
                continue
            if m > self.last_progress:
                self.last_progress = m
        return self.last_progress

    # --- signals ---
    def preempt(self):
        """Cooperative preemption: SIGTERM — a config run checkpoints
        at its next chunk boundary and exits 75 (engine.sim.Preempted);
        a cmd run dies and is simply re-run later."""
        if not self.preempting:
            self.preempting = True
            try:
                os.kill(self.proc.pid, signal.SIGTERM)
            except OSError:
                pass

    def kill(self):
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except OSError:
            try:
                self.proc.kill()
            except OSError:
                pass

    # --- exit ---
    def classify(self, rc: int) -> tuple:
        """(kind, cause): kind in done|preempt|crash. Any nonzero
        exit while WE were preempting is a preemption, not a crash —
        the scheduler asked for it."""
        if rc == 0:
            return "done", "completed"
        if rc == EXIT_PREEMPTED:
            return "preempt", "preempted (snapshot saved)"
        if self.preempting:
            return "preempt", ("preempted (grace expired; SIGKILLed)"
                               if self.preempt_killed else
                               f"preempted ({classify_exit(rc)})")
        if self.hung:
            return "crash", ("hung (no progress; SIGKILLed by "
                             "watchdog)")
        return "crash", classify_exit(rc)

    def record_exit(self, rc: int, kind: str, cause: str):
        """Per-attempt crash-cause record (the engine.supervisor
        journal shape, one per attempt, fsync'd + torn-tolerant)."""
        self.crash_log.append({
            "attempt": self.attempt, "exit_status": rc,
            "kind": kind, "cause": cause,
            "wall_s": round(time.time() - self.t0, 3),
            "resumed": self.resume,
            # drop only a leading interpreter path (config runs); a
            # cmd run's argv[0] IS the program — the post-mortem
            # needs it
            "argv": (self.argv[1:] if self.spec.get("config")
                     else self.argv),
            "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
        })

    def close(self):
        try:
            self._stdout.close()
        except OSError:
            pass


class BatchSlot(Slot):
    """One executing batch GROUP (serving.batch): a single
    child process covering N member runs, each keeping its own
    journal state. The scheduler claims every member before spawning;
    the claim gate rides the FIRST member's claim file (one child,
    one gate). Batch children carry no checkpoint store — a crashed
    group re-runs from scratch, like a cmd run — so ``resume`` is
    always False and the watchdog's progress signals are the group
    heartbeat plus every member's digest chain."""

    def __init__(self, queue: Queue, states: list, python: str = None,
                 log=None, aot_cache: str = None):
        assert states, "a batch group needs at least one member"
        self.queue = queue
        self.states = list(states)
        self.specs = [st.spec for st in self.states]
        self.member_ids = [st.id for st in self.states]
        self.spec = dict(self.specs[0])
        # the group's admission weight is the members' sum (they run
        # concurrently as lanes of one program)
        self.spec["hosts"] = sum(s.get("hosts", 1) for s in self.specs)
        self.spec["rss_mb"] = sum(s.get("rss_mb", 0)
                                  for s in self.specs)
        self.run_id = self.member_ids[0]
        self.group = self.specs[0].get("batch")
        self.attempt = self.states[0].started + 1
        self.resume = False
        self.log = log or (lambda m: sys.stderr.write(
            f"shadow_tpu_torch: fleet: {m}\n"))
        self.hung = False
        self.preempting = False
        self.preempt_killed = False
        self.crash_log = CrashLog(queue.crash_log_path(self.run_id))

        for rid in self.member_ids:
            os.makedirs(queue.run_dir(rid), exist_ok=True)
        argv = build_batch_argv(queue, self.specs, python,
                                aot_cache=aot_cache)
        env = dict(os.environ)
        env.update(self.specs[0].get("env") or {})
        env["SHADOW_TPU_FLEET_RUN_DIR"] = os.path.abspath(
            queue.run_dir(self.run_id))
        if aot_cache:
            env[AOT_ENV] = os.path.abspath(aot_cache)
        self._stdout = open(queue.log_path(self.run_id), "ab")
        self.t0 = time.time()
        self.last_progress = self.t0
        try:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", _CLAIM_GATE,
                 os.path.abspath(queue.claim_path(self.run_id))]
                + argv,
                stdout=self._stdout, stderr=subprocess.STDOUT,
                env=env, start_new_session=True)
        except OSError:
            self._stdout.close()
            raise
        self.argv = argv

    def progress_paths(self) -> list:
        q = self.queue
        paths = [os.path.join(q.run_dir(self.run_id), "heartbeat"),
                 q.log_path(self.run_id)]
        for rid in self.member_ids:
            paths.append(q.digest_path(rid))
        return paths

    def record_exit(self, rc: int, kind: str, cause: str):
        self.crash_log.append({
            "attempt": self.attempt, "exit_status": rc,
            "kind": kind, "cause": cause,
            "wall_s": round(time.time() - self.t0, 3),
            "resumed": False,
            "batch": self.group, "members": self.member_ids,
            "argv": self.argv[1:],
            "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
        })
