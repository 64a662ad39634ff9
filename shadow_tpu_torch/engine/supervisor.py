"""Auto-resume supervision: ``python -m shadow_tpu_torch --until-complete``.

Counterpart of ``shadow_tpu/engine/supervisor.py``. The supervisor runs
the simulation in a child process (the same CLI, minus the supervisor
flags), and when the child crashes it re-runs it with ``--resume
latest``, which restores the newest valid snapshot of the checkpoint
store. Retries are capped and back off exponentially; every attempt
appends a crash-cause record to ``<checkpoint base>.supervisor.jsonl``.
A resumed run's digest chain equals an uninterrupted run's. With a
trace or metrics recorder installed, each attempt is a
``supervisor.attempt`` span and the ``supervisor.*`` counters count
attempts, crashes, resumes, preemptions and give-ups.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

# exit code of a cooperative preemption (SIGTERM under --checkpoint):
# resumable, never counted as a crash
EXIT_PREEMPTED = 75

# backoff cap (s), and the preemptions tolerated before giving up: a
# child preempted on every attempt must not loop forever
BACKOFF_CAP_S = 60.0
MAX_PREEMPTIONS = 100

# flags the supervisor consumes; never forwarded to the child
_SUPERVISOR_FLAGS = {"--until-complete"}
_SUPERVISOR_OPTS = {"--max-retries", "--retry-backoff"}


def backoff_delay(base_s: float, failures: int,
                  cap_s: float = BACKOFF_CAP_S) -> float:
    """Delay before retry number `failures` (1-based): doubling from
    `base_s` up to `cap_s` (the supervisor's and the fleet's rule)."""
    return min(float(base_s) * (2 ** max(int(failures) - 1, 0)),
               float(cap_s))


class CrashLog:
    """Append-only crash-cause journal: one JSON line per attempt,
    fsynced; a torn last line is skipped on read."""

    def __init__(self, path: str, log=None):
        self.path = path
        self._log = log or (lambda msg: sys.stderr.write(
            f"shadow_tpu_torch: crash log: {msg}\n"))

    def append(self, rec: dict):
        try:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError as e:
            self._log(f"cannot write {self.path}: {e}")

    def read(self) -> list:
        out = []
        if not os.path.exists(self.path):
            return out
        with open(self.path) as f:
            for i, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except json.JSONDecodeError:
                    sys.stderr.write(
                        f"crash log: {self.path}:{i}: skipping malformed "
                        "line (torn append?)\n")
                    continue
                if isinstance(e, dict):
                    out.append(e)
        return out


def strip_supervisor_args(argv: list) -> list:
    """The child's CLI: `argv` minus the supervisor-only flags (both
    ``--opt v`` and ``--opt=v``)."""
    out = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in _SUPERVISOR_FLAGS:
            continue
        if a in _SUPERVISOR_OPTS:
            skip = True
            continue
        if any(a.startswith(opt + "=") for opt in _SUPERVISOR_OPTS):
            continue
        out.append(a)
    return out


def _strip_resume(argv: list) -> list:
    """Drop a user ``--resume X``: it applies to the first attempt
    only; retries resume from the newest state."""
    out = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--resume":
            skip = True
            continue
        if a.startswith("--resume="):
            continue
        out.append(a)
    return out


def classify_exit(status: int) -> str:
    """Child exit status -> crash cause."""
    if status == 0:
        return "completed"
    if status < 0:
        try:
            name = signal.Signals(-status).name
        except ValueError:
            name = f"signal {-status}"
        return f"killed by {name}"
    return f"exited status={status}"


class Supervisor:
    """Run one CLI invocation of the port to completion across crashes."""

    def __init__(self, child_argv: list, checkpoint: str,
                 max_retries: int = 5, backoff_s: float = 1.0, log=None):
        self.child_argv = list(child_argv)
        self.checkpoint_base = (checkpoint[:-4]
                                if checkpoint.endswith(".npz")
                                else checkpoint)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.log = log or (lambda msg: sys.stderr.write(
            f"shadow_tpu_torch: supervisor: {msg}\n"))
        self.crash_log = CrashLog(self.log_path(), log=self.log)

    def log_path(self) -> str:
        return self.checkpoint_base + ".supervisor.jsonl"

    def read_log(self) -> list:
        return self.crash_log.read()

    def _child_argv(self, attempt: int) -> list:
        cmd = [sys.executable, "-m", "shadow_tpu_torch"]
        if attempt == 1:
            return cmd + self.child_argv
        # `--resume latest` starts fresh (with a warning) when the crash
        # came before the first checkpoint
        return cmd + _strip_resume(self.child_argv) + ["--resume",
                                                       "latest"]

    def run(self) -> int:
        from ..obs import metrics as MT
        from ..obs import trace as TR

        def gave_up():
            if MT.ENABLED:
                MT.REGISTRY.counter("supervisor.gave_up").inc()

        attempt = crashes = preemptions = 0
        while True:
            attempt += 1
            argv = self._child_argv(attempt)
            resumed = attempt > 1
            t0 = time.perf_counter()
            s0 = TR.TRACER.now() if TR.ENABLED else None
            rc = subprocess.call(argv)
            wall = time.perf_counter() - t0
            cause = classify_exit(rc)
            if TR.ENABLED:
                TR.TRACER.complete(
                    "supervisor.attempt", s0,
                    args={"attempt": attempt, "exit_status": rc,
                          "cause": cause, "resumed": resumed})
            if MT.ENABLED:
                reg = MT.REGISTRY
                reg.counter("supervisor.attempts").inc()
                reg.gauge("supervisor.last_exit_status").set(rc)
                # a preemption is resumable, not a crash
                if rc not in (0, EXIT_PREEMPTED):
                    reg.counter("supervisor.crashes").inc()
                if resumed:
                    reg.counter("supervisor.resumes").inc()
            self.crash_log.append({
                "attempt": attempt, "exit_status": rc, "cause": cause,
                "wall_s": round(wall, 3), "resumed": resumed,
                "argv": argv[1:],      # drop the interpreter path
                "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
            })
            if rc == 0:
                if attempt > 1:
                    self.log(f"run completed on attempt {attempt}")
                return 0
            self.log(f"attempt {attempt} {cause}")
            if rc == 2:
                # a usage error fails the same way every time
                self.log("usage error is not a crash; not retrying")
                gave_up()
                return rc
            if rc == EXIT_PREEMPTED:
                preemptions += 1
                if MT.ENABLED:
                    MT.REGISTRY.counter("supervisor.preemptions").inc()
                if preemptions > MAX_PREEMPTIONS:
                    self.log(
                        f"preempted {preemptions} times without "
                        "completing — something SIGTERMs every "
                        "attempt; giving up (state is resumable)")
                    gave_up()
                    return rc
                self.log("child was preempted (saved a snapshot); "
                         "resuming from 'latest'")
                time.sleep(self.backoff_s)
                continue
            crashes += 1
            if crashes > self.max_retries:
                self.log(
                    f"giving up after {crashes} crashes "
                    f"({self.max_retries} retries); last cause: "
                    f"{cause}")
                gave_up()
                return rc if rc > 0 else 70    # EX_SOFTWARE for signals
            delay = backoff_delay(self.backoff_s, crashes)
            self.log(f"restarting from 'latest' in {delay:.1f}s "
                     f"(retry {crashes}/{self.max_retries})")
            if MT.ENABLED:
                MT.REGISTRY.gauge("supervisor.backoff_s").set(delay)
            time.sleep(delay)
