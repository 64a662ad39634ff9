"""Crash-safe sweep scheduler: drain the queue through any failure.

One scheduler process owns one queue (``scheduler.lock``; a stale
lock — dead pid — is taken over). The loop holds up to ``workers``
slots (fleet.worker), each a supervised child process, and per tick:

1. **reaps** finished slots — journals the exit, releases the claim,
   and classifies it: done; preempt (exit 75 → requeued resumable);
   crash (retry with exponential backoff — engine.supervisor's one
   rule — escalating to QUARANTINE past the run's max_retries, so a
   deterministic crasher parks with its crash-cause journal while
   the queue keeps draining; deterministic usage errors, rc=2,
   quarantine immediately);
2. runs the **watchdog** — a slot whose progress signals (checkpoint
   pointer / digest / log mtimes) are older than ``hang_timeout_s``
   is diagnosed hung and SIGKILLed, never wedging the slot;
3. honors **preemption** — SIGTERM to the scheduler forwards SIGTERM
   to every child (config runs checkpoint at their next chunk
   boundary and exit 75 — engine.sim.Preempted), SIGKILLs stragglers
   after a grace period, journals everything and exits 75 itself;
   restarting ``fleet run`` completes the sweep byte-identically;
4. **admits** queued runs FIFO under the admission budget: concurrent
   simulated hosts (and declared RSS) are bounded, so an oversized
   scenario waits as "queued" — and runs ALONE once the box is free —
   instead of OOMing the box;
5. publishes ``fleet.*`` **metrics** when a registry is installed.

Crash-safety of the scheduler itself: all state is the journal fold +
claim files. On startup, recovery kills any orphaned child of a dead
scheduler (its claim names the pid/process-group), journals a
``reclaim`` (NOT a crash — the run did nothing wrong) and requeues
the run as resumable.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time

from ..engine.supervisor import EXIT_PREEMPTED, backoff_delay
from .queue import TERMINAL, Queue
from .worker import BatchSlot, Slot

LOCK = "scheduler.lock"

# scheduler exit codes (fleet.cli documents them)
EXIT_DRAINED = 0          # every run done
EXIT_QUARANTINED = 3      # drained, but some runs are quarantined


def _pid_alive(pid) -> bool:
    if not pid:
        return False
    try:
        os.kill(int(pid), 0)
    except (OSError, ValueError):
        return False
    return True


class SchedulerLockError(RuntimeError):
    pass


class Scheduler:
    def __init__(self, queue: Queue, workers: int = 2,
                 max_hosts: int = 0, max_rss_mb: int = 0,
                 hang_timeout_s: float = 900.0, backoff_s: float = 1.0,
                 backoff_cap_s: float = 60.0, grace_s: float = 60.0,
                 poll_s: float = 0.2, python: str = None, log=None,
                 max_spont_preempts: int = 20):
        self.queue = queue
        self.workers = max(int(workers), 1)
        self.max_hosts = int(max_hosts)
        self.max_rss_mb = int(max_rss_mb)
        self.hang_timeout_s = float(hang_timeout_s)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.grace_s = float(grace_s)
        self.poll_s = float(poll_s)
        self.python = python
        self.log = log or (lambda m: sys.stderr.write(
            f"shadow_tpu_torch: fleet: {m}\n"))
        # spontaneous exit-75s (nobody preempted): bounded so a child
        # that always exits 75 cannot livelock the drain loop
        self.max_spont_preempts = int(max_spont_preempts)
        self.slots = []
        self._eligible_at = {}      # run_id -> wall time (backoff)
        self._spont_preempts = {}   # run_id -> spontaneous 75 count
        self._preempt = threading.Event()
        self._counters = {"starts": 0, "retries": 0, "preemptions": 0,
                          "watchdog_kills": 0, "reclaims": 0,
                          "quarantines": 0}

    # --- preemption (SIGTERM handler calls this) ---
    def request_preempt(self):
        self._preempt.set()

    # --- single-scheduler lock ---
    def lock_path(self) -> str:
        return os.path.join(self.queue.root, LOCK)

    def _acquire_lock(self):
        self.queue.ensure()
        # the lock must be COMPLETE when it becomes visible: write a
        # private tmp first and publish with os.link (which fails
        # EEXIST like O_EXCL) — a contender reading a half-written
        # lock would misjudge a live scheduler as stale garbage
        tmp = f"{self.lock_path()}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"pid": os.getpid(),
                       "t": round(time.time(), 3)}, f)
            f.flush()
            os.fsync(f.fileno())
        try:
            self._acquire_lock_from(tmp)
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _acquire_lock_from(self, tmp: str):
        for _ in range(3):
            try:
                os.link(tmp, self.lock_path())
                return
            except FileExistsError:
                try:
                    with open(self.lock_path()) as f:
                        holder = json.load(f)
                except FileNotFoundError:
                    continue           # raced a takeover; re-examine
                except (OSError, json.JSONDecodeError):
                    # locks are published complete (link-from-tmp), so
                    # an unparsable one is pre-publication garbage
                    # from an older writer — treat as stale
                    holder = {}
                if _pid_alive(holder.get("pid")):
                    raise SchedulerLockError(
                        f"another scheduler (pid {holder.get('pid')}) "
                        f"holds {self.lock_path()}; one scheduler per "
                        "queue")
                # takeover must be ATOMIC: renaming the stale lock
                # aside succeeds for exactly ONE contender (a plain
                # unlink-and-retry lets a second concurrent starter
                # unlink the winner's FRESH lock — two schedulers on
                # one queue). The loser's rename raises ENOENT and it
                # re-examines whatever lock now exists.
                stale = f"{self.lock_path()}.stale.{os.getpid()}"
                try:
                    os.rename(self.lock_path(), stale)
                except OSError:
                    continue           # lost the takeover race
                self.log(f"taking over stale scheduler lock "
                         f"(dead pid {holder.get('pid')})")
                try:
                    os.unlink(stale)
                except OSError:
                    pass
        raise SchedulerLockError(
            f"could not acquire {self.lock_path()}")

    def _release_lock(self):
        try:
            os.unlink(self.lock_path())
        except OSError:
            pass

    # --- recovery: a dead scheduler's in-flight runs ---
    @staticmethod
    def _looks_like_claimed_child(pid, argv, claim_path) -> bool:
        """Pid-reuse guard before a recovery SIGKILL: the live
        process must still be the claimed child — its /proc cmdline
        matches the claim's recorded argv (post-exec), or carries the
        run's unique claim path (the pre-exec claim-gate wrapper
        names it in its own argv). An unreadable /proc or any other
        command line means the pid was recycled by an unrelated
        process — reclaim the run but do NOT kill."""
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                parts = [p.decode(errors="replace")
                         for p in f.read().split(b"\0") if p]
        except OSError:
            return False
        if argv and parts == list(argv):
            return True
        ab = os.path.abspath(claim_path)
        return any(p == ab for p in parts)

    def _recover(self, states: dict):
        for rid in self.queue.claimed_ids():
            claim = self.queue.read_claim(rid) or {}
            # only the CHILD pid is killable; a claim holding just the
            # dead scheduler's pid means the child never got published
            # — with the stopped-spawn handshake it never ran either
            pid = claim.get("pid")
            if _pid_alive(pid):
                if self._looks_like_claimed_child(
                        pid, claim.get("argv"),
                        self.queue.claim_path(rid)):
                    # orphan of a dead scheduler (we hold the lock, so
                    # no live scheduler owns it): kill its whole
                    # process group; the run resumes from its newest
                    # snapshot
                    self.log(f"run {rid}: killing orphaned child "
                             f"(pid {pid}) of a dead scheduler")
                    try:
                        os.killpg(int(pid), signal.SIGKILL)
                    except OSError:
                        try:
                            os.kill(int(pid), signal.SIGKILL)
                        except OSError:
                            pass
                else:
                    self.log(
                        f"run {rid}: claimed pid {pid} is alive but "
                        "no longer matches the claim (pid reuse?) — "
                        "reclaiming without killing")
            st = states.get(rid)
            if st is not None and st.state == "running":
                self.queue.append("reclaim", id=rid, pid=pid)
                st.reclaims += 1
                st.state = "queued"
                self._counters["reclaims"] += 1
            self.queue.release(rid)

    # --- admission control ---
    def admissible(self, spec: dict) -> bool:
        """Bound CONCURRENT totals. A run whose weight alone exceeds
        the budget is not starved: it is admitted when nothing else
        runs (alone it cannot stack with anything, which is the OOM
        the bound exists to prevent)."""
        if not self.slots:
            return True
        if self.max_hosts:
            used = sum(s.spec.get("hosts", 1) for s in self.slots)
            if used + spec.get("hosts", 1) > self.max_hosts:
                return False
        if self.max_rss_mb:
            used = sum(s.spec.get("rss_mb", 0) for s in self.slots)
            if used + spec.get("rss_mb", 0) > self.max_rss_mb:
                return False
        return True

    # --- one reaped exit ---
    def _handle_exit(self, slot: Slot, rc: int, states: dict):
        if isinstance(slot, BatchSlot):
            return self._handle_batch_exit(slot, rc, states)
        st = states[slot.run_id]
        kind, cause = slot.classify(rc)
        slot.record_exit(rc, kind, cause)
        self.queue.append("exit", id=slot.run_id, attempt=slot.attempt,
                          rc=rc, kind=kind, cause=cause,
                          wall_s=round(time.time() - slot.t0, 3))
        self.queue.release(slot.run_id)
        slot.close()
        st.last_rc, st.last_cause, st.pid = rc, cause, None
        if kind == "done":
            st.state = "done"
            self.log(f"run {slot.run_id}: completed "
                     f"(attempt {slot.attempt})")
            return
        if kind == "preempt":
            st.preemptions += 1
            st.state = "queued"
            if not slot.preempting:
                # a 75 nobody asked for (the child preempted itself,
                # or something external SIGTERMs it every attempt):
                # resumable, but backed off and CAPPED — an
                # always-75 child must not livelock the drain loop
                n = self._spont_preempts.get(slot.run_id, 0) + 1
                self._spont_preempts[slot.run_id] = n
                if n > self.max_spont_preempts:
                    self._quarantine(
                        st, f"preempted {n} times without a "
                        "scheduler preemption (exit-75 livelock); "
                        f"last: {cause}")
                    return
                self._eligible_at[slot.run_id] = (
                    time.time() + backoff_delay(self.backoff_s, n,
                                                self.backoff_cap_s))
            self.log(f"run {slot.run_id}: {cause}; requeued resumable")
            return
        self._register_crash(st, rc, cause)

    def _handle_batch_exit(self, slot: BatchSlot, rc: int,
                           states: dict):
        """One batch child's exit fans out to every member's journal
        state: done marks all members done; preempt requeues them
        (re-run from scratch — batch children carry no checkpoint);
        a crash escalates EACH member's own retry→quarantine count,
        so a poisoned group parks member by member while the rest of
        the queue drains."""
        kind, cause = slot.classify(rc)
        slot.record_exit(rc, kind, cause)
        wall = round(time.time() - slot.t0, 3)
        for rid in slot.member_ids:
            self.queue.append("exit", id=rid, attempt=slot.attempt,
                              rc=rc, kind=kind, cause=cause,
                              wall_s=wall, batch=slot.group)
            self.queue.release(rid)
        slot.close()
        for rid in slot.member_ids:
            st = states[rid]
            st.last_rc, st.last_cause, st.pid = rc, cause, None
            if kind == "done":
                st.state = "done"
            elif kind == "preempt":
                st.preemptions += 1
                st.state = "queued"
            else:
                self._register_crash(st, rc, cause)
        if kind == "done":
            self.log(f"batch {slot.group}: completed "
                     f"({len(slot.member_ids)} members, attempt "
                     f"{slot.attempt})")
        elif kind == "preempt":
            if not slot.preempting:
                n = self._spont_preempts.get(slot.run_id, 0) + 1
                self._spont_preempts[slot.run_id] = n
                if n > self.max_spont_preempts:
                    for rid in slot.member_ids:
                        self._quarantine(
                            states[rid],
                            f"batch preempted {n} times without a "
                            "scheduler preemption (exit-75 "
                            f"livelock); last: {cause}")
                    return
                delay = backoff_delay(self.backoff_s, n,
                                      self.backoff_cap_s)
                for rid in slot.member_ids:
                    self._eligible_at[rid] = time.time() + delay
            self.log(f"batch {slot.group}: {cause}; members requeued "
                     "(batch retries re-run from scratch)")

    def _quarantine(self, st, why: str):
        self.queue.append("quarantine", id=st.id, cause=why,
                          crashes=st.crashes,
                          crash_log=self.queue.crash_log_path(st.id))
        st.state = "quarantined"
        st.quarantine_cause = why
        self._counters["quarantines"] += 1
        self.log(f"run {st.id}: QUARANTINED — {why} (crash causes: "
                 f"{self.queue.crash_log_path(st.id)})")

    def _register_crash(self, st, rc, cause: str):
        """The crash-exit escalation, shared by reaped exits and
        spawn failures: retry with backoff, quarantine past the
        run's max_retries (usage errors immediately)."""
        st.crashes += 1
        st.state = "queued"
        max_retries = int(st.spec.get("max_retries", 3))
        if rc == 2 or st.crashes > max_retries:
            self._quarantine(
                st, ("deterministic usage error (rc=2); not retried"
                     if rc == 2 else
                     f"{st.crashes} crashes (> {max_retries} "
                     f"retries); last: {cause}"))
            return
        delay = backoff_delay(self.backoff_s, st.crashes,
                              self.backoff_cap_s)
        self._eligible_at[st.id] = time.time() + delay
        self._counters["retries"] += 1
        self.log(f"run {st.id}: {cause}; retry "
                 f"{st.crashes}/{max_retries} in {delay:.1f}s"
                 + (" (resume latest)" if st.spec.get("config")
                    else ""))

    def _handle_spawn_failure(self, st, err: OSError):
        """The child never existed (bad executable, claim write
        failure): journal + crash-log the attempt and ride the normal
        crash escalation — the scheduler itself never dies of it."""
        from ..engine.supervisor import CrashLog
        cause = f"spawn failed: {err}"
        attempt = st.started + 1
        CrashLog(self.queue.crash_log_path(st.id),
                 log=self.log).append({
            "attempt": attempt, "exit_status": None, "kind": "crash",
            "cause": cause, "wall_s": 0.0, "resumed": st.resume,
            "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
        })
        self.queue.append("exit", id=st.id, attempt=attempt, rc=None,
                          kind="crash", cause=cause, wall_s=0.0)
        self.queue.release(st.id)
        st.last_rc, st.last_cause = None, cause
        self._register_crash(st, None, cause)

    # --- metrics ---
    def _publish(self, states: dict):
        from ..obs import metrics as MT
        if not MT.ENABLED:
            return
        reg = MT.REGISTRY
        by_state = {"queued": 0, "running": 0, "done": 0,
                    "quarantined": 0}
        for st in states.values():
            by_state[st.state] = by_state.get(st.state, 0) + 1
        for k, v in by_state.items():
            reg.gauge(f"fleet.{k}").set(v)
        reg.gauge("fleet.slots_busy").set(len(self.slots))
        for k, v in self._counters.items():
            c = reg.counter(f"fleet.{k}")
            c.n = v                       # absolute, scheduler-owned

    def _claim(self, run_id: str) -> bool:
        """Claim one run, reclaiming a dead holder's stale claim."""
        if self.queue.claim(run_id, {"scheduler_pid": os.getpid()}):
            return True
        claim = self.queue.read_claim(run_id) or {}
        if _pid_alive(claim.get("pid")):
            return False          # genuinely held (shouldn't happen
            #   under the lock) — skip
        self.queue.release(run_id)
        return self.queue.claim(run_id,
                                {"scheduler_pid": os.getpid()})

    def _admit_batch(self, st, states: dict, now: float,
                     slotted: set) -> bool:
        """Try to admit the whole batch group `st` belongs to as ONE
        BatchSlot. All non-terminal members must be queued and past
        their backoff; the group's admission weight is the members'
        sum. Returns True when a slot started."""
        gid = st.spec.get("batch")
        group = [s for s in states.values()
                 if s.spec.get("batch") == gid
                 and s.state not in TERMINAL]
        if not group:
            return False
        for m in group:
            if (m.state != "queued" or m.id in slotted
                    or now < self._eligible_at.get(m.id, 0)):
                return False
        weight = {"hosts": sum(m.spec.get("hosts", 1) for m in group),
                  "rss_mb": sum(m.spec.get("rss_mb", 0)
                                for m in group)}
        if not self.admissible(weight):
            return False
        claimed = []
        for m in group:
            if not self._claim(m.id):
                for rid in claimed:
                    self.queue.release(rid)
                return False
            claimed.append(m.id)
        try:
            slot = BatchSlot(self.queue, group, python=self.python,
                             log=self.log)
        except OSError as e:
            for m in group:
                self._handle_spawn_failure(m, e)
            return False
        try:
            slot.start()
        except OSError as e:
            slot.close()
            for m in group:
                self._handle_spawn_failure(m, e)
            return False
        for m in group:
            m.state = "running"
            m.started += 1
            m.pid = slot.proc.pid
            self.queue.append("start", id=m.id, attempt=slot.attempt,
                              pid=slot.proc.pid, resume=False,
                              batch=gid)
        self.slots.append(slot)
        self._counters["starts"] += 1
        self.log(f"batch {gid}: started attempt {slot.attempt} "
                 f"({len(group)} members, pid {slot.proc.pid})")
        return True

    def _slotted_ids(self) -> set:
        """Every run id currently covered by a slot — a BatchSlot
        covers all its members, not just its leading run_id."""
        ids = set()
        for s in self.slots:
            if isinstance(s, BatchSlot):
                ids.update(s.member_ids)
            else:
                ids.add(s.run_id)
        return ids

    # --- the drain loop ---
    def run(self) -> int:
        self.queue.ensure()
        self._acquire_lock()
        try:
            states = self.queue.fold()
            if not states:
                self.log("queue is empty; nothing to do")
                return EXIT_DRAINED
            self._recover(states)
            n_all = len(states)
            self.log(f"draining {n_all} runs "
                     f"({sum(1 for s in states.values() if s.state in TERMINAL)} "
                     f"already terminal) with {self.workers} workers")
            while True:
                # 1. reap
                for slot in list(self.slots):
                    rc = slot.proc.poll()
                    if rc is None:
                        continue
                    self.slots.remove(slot)
                    self._handle_exit(slot, rc, states)
                # 2. watchdog
                now = time.time()
                for slot in self.slots:
                    if slot.hung or slot.preempting:
                        continue
                    if (now - slot.check_progress()
                            > self.hang_timeout_s):
                        slot.hung = True
                        self._counters["watchdog_kills"] += 1
                        self.log(
                            f"run {slot.run_id}: no progress for "
                            f"{self.hang_timeout_s:.0f}s — diagnosing "
                            "hung; SIGKILL")
                        slot.kill()
                # 3. preemption
                if self._preempt.is_set():
                    return self._drain_preempt(states)
                # 4. admit
                slotted = self._slotted_ids()
                for st in states.values():
                    if len(self.slots) >= self.workers:
                        break
                    if st.state != "queued":
                        continue
                    if st.id in slotted:
                        continue
                    if now < self._eligible_at.get(st.id, 0):
                        continue
                    if st.spec.get("batch"):
                        if self._admit_batch(st, states, now,
                                             slotted):
                            slotted = self._slotted_ids()
                        continue
                    if not self.admissible(st.spec):
                        continue
                    if not self._claim(st.id):
                        continue
                    try:
                        slot = Slot(self.queue, st, python=self.python,
                                    log=self.log)
                    except OSError as e:
                        self._handle_spawn_failure(st, e)
                        continue
                    try:
                        slot.start()
                    except OSError as e:
                        slot.close()
                        # an unspawnable child (bad executable, claim
                        # write failure) is a CRASH of that run, never
                        # of the scheduler — it rides the normal
                        # retry→quarantine escalation while the rest
                        # of the queue keeps draining
                        self._handle_spawn_failure(st, e)
                        continue
                    st.state = "running"
                    st.started += 1
                    st.pid = slot.proc.pid
                    self.slots.append(slot)
                    slotted.add(st.id)
                    self._counters["starts"] += 1
                    self.queue.append(
                        "start", id=st.id, attempt=slot.attempt,
                        pid=slot.proc.pid, resume=slot.resume)
                    self.log(f"run {st.id}: started attempt "
                             f"{slot.attempt} (pid {slot.proc.pid}"
                             f"{', resume latest' if slot.resume else ''})")
                # 5. metrics
                self._publish(states)
                # 6. done? (a queued run always starts eventually —
                # backoff expires, and admission admits any run alone
                # — so "drained" means everything is terminal)
                if not self.slots and all(
                        st.state in TERMINAL
                        for st in states.values()):
                    break
                time.sleep(self.poll_s)
            quarantined = [st.id for st in states.values()
                           if st.state == "quarantined"]
            done = sum(1 for st in states.values()
                       if st.state == "done")
            self.log(f"queue drained: {done}/{n_all} done"
                     + (f", {len(quarantined)} quarantined "
                        f"({', '.join(quarantined)})"
                        if quarantined else ""))
            return EXIT_QUARANTINED if quarantined else EXIT_DRAINED
        finally:
            self._release_lock()

    def _drain_preempt(self, states: dict) -> int:
        """SIGTERM every child, give them `grace_s` to checkpoint and
        exit 75, SIGKILL stragglers, journal + requeue everything,
        then exit 75 ourselves: the next ``fleet run`` resumes the
        sweep exactly where it stopped."""
        self.log(f"preempted: signalling {len(self.slots)} running "
                 f"child(ren); grace {self.grace_s:.0f}s")
        for slot in self.slots:
            slot.preempt()
        deadline = time.time() + self.grace_s
        while self.slots and time.time() < deadline:
            for slot in list(self.slots):
                rc = slot.proc.poll()
                if rc is not None:
                    self.slots.remove(slot)
                    self._handle_exit(slot, rc, states)
            time.sleep(min(self.poll_s, 0.1))
        for slot in list(self.slots):
            slot.preempt_killed = True
            slot.kill()
            rc = slot.proc.wait()
            self.slots.remove(slot)
            self._handle_exit(slot, rc, states)
        self._counters["preemptions"] += 1
        self._publish(states)
        self.log("preemption complete; restart `fleet run` to resume "
                 "the sweep")
        return EXIT_PREEMPTED
