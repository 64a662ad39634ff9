"""Durable on-disk run queue: fsync'd JSONL journal + atomic claims.

Layout under one queue directory ``Q``:

- ``Q/queue.jsonl`` — the journal: every transition (submit, start,
  exit, requeue, quarantine, reclaim) is ONE fsync'd JSON line
  (obs.ledger.jsonl_append), so a SIGKILL can lose nothing and tear
  at most the line in flight — which reads skip (torn-line tolerant,
  the same crash shape as the perf ledger and the digest chain). The
  queue's current state is a pure FOLD over the journal (fold()):
  there is no mutable state file to corrupt.
- ``Q/claims/<id>.claim`` — atomic claim file (O_EXCL) naming the
  scheduler + child pid executing a run; prevents double execution
  and lets a restarted scheduler find in-flight runs of a dead one.
- ``Q/runs/<id>/`` — the run's working directory: its checkpoint
  store (``ck.*`` — engine.checkpoint.run_store_base namespacing),
  digest chain (``digest.jsonl``), child stdout (``run.log``),
  crash-cause journal (``crash.jsonl``), and a private copy of the
  scenario XML (``config.xml`` — the queue is self-contained; the
  submitted path may be a temp file).
- ``Q/scheduler.lock`` — single-scheduler mutual exclusion
  (fleet.scheduler).

Run specs carry two execution modes: ``config`` runs a scenario XML
through the ``python -m shadow_tpu_torch`` CLI with MANAGED durability args
(checkpoint store, digest chain, ``--resume latest`` on re-dispatch —
fleet.worker), while ``cmd`` runs an arbitrary argv (bench lines,
tests) that is simply re-run from scratch on retry.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import time

from ..engine.checkpoint import run_store_base, valid_run_id
from ..obs.ledger import jsonl_append, jsonl_read

JOURNAL = "queue.jsonl"

# terminal states; everything else keeps the scheduler loop alive
TERMINAL = ("done", "quarantined")


def make_spec(run_id: str, config: str = None, cmd: list = None,
              args: list = None, env: dict = None, hosts: int = 1,
              rss_mb: int = 0, max_retries: int = 3,
              checkpoint_every: float = 10.0, digest: bool = True,
              digest_every: int = 0, perf: str = None,
              netscope: bool = False, batch: str = None,
              batch_seed: int = None, device: str = "cuda") -> dict:
    """One run spec (a journal ``submit`` payload). Exactly one of
    `config` (scenario XML path — managed durability) and `cmd`
    (arbitrary argv — rerun-from-scratch retries) must be set.
    `hosts`/`rss_mb` are the admission-control weights; `args` extra
    CLI arguments for config runs (seed, faults, engine caps...);
    `perf` non-None appends a per-run perf-ledger entry on completion
    ("" = the default ledger path); `netscope` streams the child's
    network observatory time-series into the run directory
    (obs.netscope — ``fleet status --ensemble`` folds them). `batch` names a batch
    group (serving.batch): every member of the group executes in ONE
    child (``python -m shadow_tpu_torch batch``) while keeping its own
    journal state; `batch_seed` is the member's seed in the
    one-XML-many-seeds form. Batch members are config runs WITHOUT
    managed checkpoints (a crashed batch re-runs from scratch, like
    a cmd run). `device` is the torch device the run and batch
    children get (``--device``)."""
    if not valid_run_id(run_id):
        raise ValueError(
            f"run id {run_id!r} is not path-safe (letters/digits/._- "
            "only, starting with an alphanumeric)")
    if bool(config) == bool(cmd):
        raise ValueError("a run spec needs exactly one of config=XML "
                         "or cmd=[argv]")
    if batch is not None and not config:
        raise ValueError("batch members are config runs")
    return {
        "id": run_id,
        "config": config,
        "cmd": list(cmd) if cmd else None,
        "args": list(args or []),
        "env": dict(env or {}),
        "hosts": int(hosts),
        "rss_mb": int(rss_mb),
        "max_retries": int(max_retries),
        "checkpoint_every": float(checkpoint_every),
        "digest": bool(digest),
        "digest_every": int(digest_every),
        "perf": perf,
        "netscope": bool(netscope),
        "batch": batch,
        "batch_seed": batch_seed,
        "device": device,
    }


@dataclasses.dataclass
class RunState:
    """One run's folded state. `crashes` counts crash-kind exits (the
    retry/quarantine counter); `started` counts dispatches — any run
    started at least once is re-dispatched with ``--resume latest``
    (the CLI starts fresh, with a warning, when the crash predated
    the first snapshot)."""
    spec: dict
    state: str = "queued"     # queued | running | done | quarantined
    started: int = 0
    crashes: int = 0
    preemptions: int = 0
    reclaims: int = 0
    pid: int = None
    last_rc: int = None
    last_cause: str = None
    quarantine_cause: str = None

    @property
    def id(self) -> str:
        return self.spec["id"]

    @property
    def resume(self) -> bool:
        return self.started > 0


class Queue:
    """Owns one queue directory; every mutation is a journal append."""

    def __init__(self, root: str):
        self.root = root
        self.journal = os.path.join(root, JOURNAL)
        self.claims_dir = os.path.join(root, "claims")
        self.runs_dir = os.path.join(root, "runs")

    def ensure(self):
        os.makedirs(self.claims_dir, exist_ok=True)
        os.makedirs(self.runs_dir, exist_ok=True)
        return self

    def exists(self) -> bool:
        return os.path.exists(self.journal)

    # --- journal ---
    def append(self, op: str, **fields):
        """One fsync'd journal line; the crash-safety of the whole
        queue reduces to this call's durability."""
        rec = {"op": op, "t": round(time.time(), 3), **fields}
        jsonl_append(self.journal, rec, fsync=True, sort_keys=True)
        return rec

    def entries(self) -> list:
        return jsonl_read(self.journal, label="fleet queue")

    def submit(self, spec: dict) -> str:
        """Durably enqueue one run: copy its scenario XML into the
        run directory (self-contained queue), then journal the
        submit. Duplicate ids are refused — a resubmitted id would
        make the fold ambiguous."""
        self.ensure()
        if spec["id"] in self.fold():
            raise ValueError(f"run id {spec['id']!r} already queued "
                             f"in {self.root}")
        if spec.get("config"):
            rd = self.run_dir(spec["id"])
            os.makedirs(rd, exist_ok=True)
            # keep the original basename: the perf ledger labels a
            # --perf run's scenario from it (obs.ledger trajectories).
            # Stored ABSOLUTE: a later `fleet run` may start from a
            # different cwd than this submit, and a cwd-relative path
            # would resolve to nothing there (rc=2 → instant
            # quarantine of the whole sweep)
            dst = os.path.abspath(
                os.path.join(rd, os.path.basename(spec["config"])))
            shutil.copyfile(spec["config"], dst)
            spec = dict(spec, config=dst)
        self.append("submit", run=spec)
        return spec["id"]

    def fold(self) -> dict:
        """Journal -> {run_id: RunState}, submission-ordered (dicts
        preserve insertion order — the scheduler's FIFO). Unknown ops
        and records for unknown runs are skipped with a warning, so a
        newer journal never crashes an older reader."""
        states: dict = {}
        for rec in self.entries():
            op = rec.get("op")
            if op == "submit":
                spec = rec.get("run") or {}
                rid = spec.get("id")
                if not rid or rid in states:
                    sys.stderr.write(
                        f"fleet queue: {self.journal}: skipping "
                        f"duplicate/invalid submit {rid!r}\n")
                    continue
                states[rid] = RunState(spec=spec)
                continue
            st = states.get(rec.get("id"))
            if st is None:
                sys.stderr.write(
                    f"fleet queue: {self.journal}: {op} record for "
                    f"unknown run {rec.get('id')!r} — skipped\n")
                continue
            if op == "start":
                st.state = "running"
                st.started += 1
                st.pid = rec.get("pid")
            elif op == "exit":
                st.last_rc = rec.get("rc")
                st.last_cause = rec.get("cause")
                st.pid = None
                kind = rec.get("kind")
                if kind == "done":
                    st.state = "done"
                elif kind == "preempt":
                    st.preemptions += 1
                    st.state = "queued"
                else:                    # crash (incl. watchdog kills)
                    st.crashes += 1
                    st.state = "queued"
            elif op == "reclaim":
                # a dead scheduler's in-flight run, found via its
                # stale claim: requeued as resumable, NOT counted as
                # a crash (the run did nothing wrong)
                st.reclaims += 1
                st.pid = None
                if st.state == "running":
                    st.state = "queued"
            elif op == "quarantine":
                st.state = "quarantined"
                st.quarantine_cause = rec.get("cause")
            else:
                sys.stderr.write(
                    f"fleet queue: {self.journal}: unknown op "
                    f"{op!r} — skipped\n")
        return states

    # --- per-run paths ---
    def run_dir(self, run_id: str) -> str:
        return os.path.join(self.runs_dir, run_id)

    def store_base(self, run_id: str) -> str:
        """The run's checkpoint-store base (engine.checkpoint
        namespacing: rotation, ``latest`` pointer, crash log and
        hosted sidecars all live under the run's own directory)."""
        return run_store_base(self.runs_dir, run_id)

    def digest_path(self, run_id: str) -> str:
        return os.path.join(self.run_dir(run_id), "digest.jsonl")

    def netscope_path(self, run_id: str) -> str:
        return os.path.join(self.run_dir(run_id), "netscope.jsonl")

    def log_path(self, run_id: str) -> str:
        return os.path.join(self.run_dir(run_id), "run.log")

    def crash_log_path(self, run_id: str) -> str:
        return os.path.join(self.run_dir(run_id), "crash.jsonl")

    # --- claims ---
    def claim_path(self, run_id: str) -> str:
        return os.path.join(self.claims_dir, run_id + ".claim")

    def claim(self, run_id: str, meta: dict) -> bool:
        """Atomically claim a run (O_EXCL): exactly one worker slot
        can hold it. False = someone else holds it."""
        self.ensure()
        try:
            fd = os.open(self.claim_path(run_id),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "w") as f:
            json.dump({"t": round(time.time(), 3), **meta}, f)
            f.flush()
            os.fsync(f.fileno())
        return True

    def read_claim(self, run_id: str) -> dict | None:
        try:
            with open(self.claim_path(run_id)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, json.JSONDecodeError):
            # torn claim (killed mid-write): holder unknowable —
            # report it as an empty claim so recovery reclaims it
            return {}

    def release(self, run_id: str):
        try:
            os.unlink(self.claim_path(run_id))
        except OSError:
            pass

    def claimed_ids(self) -> list:
        try:
            names = os.listdir(self.claims_dir)
        except OSError:
            return []
        return sorted(n[:-len(".claim")] for n in names
                      if n.endswith(".claim"))
