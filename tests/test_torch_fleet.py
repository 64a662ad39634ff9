"""The port's fleet (``shadow_tpu_torch/fleet/``): tests/test_fleet.py's
fast machinery cases against the port's copy — journal fold and torn
lines, claims, run-store namespacing, crash logs, backoff and
quarantine, admission, the watchdog, preemption, the lock and the
scheduler's own SIGKILL recovery — merged into few items, then one
sweep of two port runs and a two-member batch group on the CPU whose
every chain equals its run alone.

Most children are ``cmd`` runs (plain Python, no engine); the sweep's
children are ``python -m shadow_tpu_torch`` processes on the CPU.
"""

import io
import os
import signal
import subprocess
import sys
import threading
import time
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from shadow_tpu_torch.core.config import HostSpec, Scenario, load_xml
from shadow_tpu_torch.engine.checkpoint import run_store_base
from shadow_tpu_torch.engine.supervisor import (EXIT_PREEMPTED, CrashLog,
                                                backoff_delay,
                                                classify_exit)
from shadow_tpu_torch.fleet import cli as FC
from shadow_tpu_torch.fleet.queue import Queue, make_spec
from shadow_tpu_torch.fleet.scheduler import (EXIT_DRAINED,
                                              EXIT_QUARANTINED, Scheduler,
                                              SchedulerLockError)
from shadow_tpu_torch.fleet.worker import (build_batch_argv,
                                           build_child_argv)

from test_fleet import PHOLD_CAPS, PHOLD_XML

REPO = Path(__file__).resolve().parent.parent


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("SHADOW_TPU_FLEET_RUN_DIR", None)
    return env


def quiet_log(_msg):
    pass


def sleeper_cmd(seconds, marker=None):
    body = f"import time; time.sleep({seconds})"
    if marker:
        body = f"open({str(marker)!r}, 'a').write('x'); " + body
    return [sys.executable, "-c", body]


def test_queue_journal_claims_and_store_layout(tmp_path):
    """The queue state is a fold over the fsync'd journal (a torn last
    line is skipped); duplicate submits and bad specs are refused;
    claims are exclusive; run stores never escape the runs root; the
    crash log tolerates a torn line; backoff and exit classification
    follow the supervisor's rule."""
    q = Queue(str(tmp_path / "q")).ensure()
    q.submit(make_spec("a", cmd=["true"]))
    q.submit(make_spec("b", cmd=["true"]))
    q.append("start", id="a", attempt=1, pid=1234)
    q.append("exit", id="a", attempt=1, rc=-9, kind="crash",
             cause="killed by SIGKILL")
    q.append("start", id="a", attempt=2, pid=1235)
    q.append("exit", id="a", attempt=2, rc=0, kind="done",
             cause="completed")
    with open(q.journal, "a") as f:
        f.write('{"op": "start", "id": "b", "att')
    st = q.fold()
    assert st["a"].state == "done" and st["a"].crashes == 1
    assert st["a"].started == 2
    assert st["b"].state == "queued" and st["b"].started == 0
    q.append("exit", id="ghost", rc=0, kind="done", cause="x")
    q.append("frobnicate", id="a")
    assert q.fold()["a"].state == "done"
    with pytest.raises(ValueError, match="already queued"):
        q.submit(make_spec("a", cmd=["true"]))

    with pytest.raises(ValueError, match="path-safe"):
        make_spec("../escape", cmd=["true"])
    with pytest.raises(ValueError, match="exactly one"):
        make_spec("x", config="a.xml", cmd=["true"])
    with pytest.raises(ValueError, match="exactly one"):
        make_spec("x")
    assert make_spec("x", cmd=["true"])["device"] == "cuda"

    assert q.claim("r1", {"pid": 1}) is True
    assert q.claim("r1", {"pid": 2}) is False
    assert q.read_claim("r1")["pid"] == 1
    assert q.claimed_ids() == ["r1"]
    q.release("r1")
    assert q.read_claim("r1") is None
    assert q.claim("r1", {"pid": 3}) is True

    a, b = q.store_base("run-a"), q.store_base("run-b")
    assert a != b and a.startswith(q.runs_dir)
    for bad in ("../up", "a/b", "", ".hidden", "x" * 101):
        with pytest.raises(ValueError):
            run_store_base(str(tmp_path), bad)

    log = CrashLog(str(tmp_path / "crash.jsonl"))
    log.append({"attempt": 1, "exit_status": -9,
                "cause": "killed by SIGKILL"})
    log.append({"attempt": 2, "exit_status": 0, "cause": "completed"})
    with open(log.path, "a") as f:
        f.write('{"attempt": 3, "exit_st')
    assert [r["attempt"] for r in log.read()] == [1, 2]

    assert backoff_delay(1.0, 1) == 1.0
    assert backoff_delay(1.0, 3) == 4.0
    assert backoff_delay(1.0, 30, cap_s=60.0) == 60.0
    assert classify_exit(0) == "completed"
    assert classify_exit(-signal.SIGKILL) == "killed by SIGKILL"
    assert classify_exit(3) == "exited status=3"


def test_scheduler_retries_then_quarantines(tmp_path):
    """A deterministic crasher is retried with backoff and quarantined
    with its crash journal while the rest drains; an unspawnable child
    is a crash of its run; a child that always exits 75 is capped; a
    usage error (rc 2) quarantines at once."""
    q = Queue(str(tmp_path / "q1")).ensure()
    for i in range(3):
        q.submit(make_spec(f"ok{i}",
                           cmd=sleeper_cmd(0.1, tmp_path / f"done{i}")))
    q.submit(make_spec("poison",
                       cmd=[sys.executable, "-c", "raise SystemExit(9)"],
                       max_retries=2))
    q.submit(make_spec("ghost", cmd=["/no/such/executable-xyz"],
                       max_retries=1))
    assert Scheduler(q, workers=2, backoff_s=0.05, backoff_cap_s=0.1,
                     log=quiet_log).run() == EXIT_QUARANTINED
    st = q.fold()
    assert all(st[f"ok{i}"].state == "done" for i in range(3))
    assert all((tmp_path / f"done{i}").exists() for i in range(3))
    assert st["poison"].state == "quarantined"
    assert st["poison"].crashes == 3
    recs = CrashLog(q.crash_log_path("poison")).read()
    assert [r["cause"] for r in recs] == ["exited status=9"] * 3
    assert st["ghost"].state == "quarantined" and st["ghost"].crashes == 2
    assert q.claimed_ids() == []

    q = Queue(str(tmp_path / "q2")).ensure()
    q.submit(make_spec("tempfail",
                       cmd=[sys.executable, "-c", "raise SystemExit(75)"]))
    q.submit(make_spec("usage",
                       cmd=[sys.executable, "-c", "raise SystemExit(2)"],
                       max_retries=5))
    assert Scheduler(q, workers=1, backoff_s=0.02, backoff_cap_s=0.05,
                     max_spont_preempts=2,
                     log=quiet_log).run() == EXIT_QUARANTINED
    st = q.fold()
    assert st["tempfail"].state == "quarantined"
    assert st["tempfail"].preemptions == 3 and st["tempfail"].crashes == 0
    assert "livelock" in st["tempfail"].quarantine_cause
    assert st["usage"].state == "quarantined" and st["usage"].crashes == 1
    assert "usage error" in st["usage"].quarantine_cause


def test_scheduler_admission_bounds_concurrency(tmp_path):
    """Concurrent host weight never exceeds the budget; an oversized
    run waits, then runs alone."""
    q = Queue(str(tmp_path / "q")).ensure()
    trace = tmp_path / "trace"

    def tracked(rid, hosts):
        body = (f"import time; f=open({str(trace)!r},'a'); "
                f"f.write('+{hosts}\\n'); f.flush(); time.sleep(0.4); "
                f"f.write('-{hosts}\\n'); f.flush()")
        q.submit(make_spec(rid, cmd=[sys.executable, "-c", body],
                           hosts=hosts))

    for rid, hosts in (("small1", 4), ("small2", 4), ("oversized", 50),
                       ("small3", 4)):
        tracked(rid, hosts)
    assert Scheduler(q, workers=3, max_hosts=10, backoff_s=0.05,
                     log=quiet_log).run() == EXIT_DRAINED
    lines = trace.read_text().splitlines()
    load = peak = 0
    for line in lines:
        load += int(line)
        peak = max(peak, load)
    assert peak <= 50
    start50 = lines.index("+50")
    assert sum(int(x) for x in lines[:start50]) == 0
    assert lines[start50 + 1] == "-50"


def test_scheduler_watchdog_kills_hung_run(tmp_path):
    q = Queue(str(tmp_path / "q")).ensure()
    q.submit(make_spec("hung", cmd=sleeper_cmd(60), max_retries=0))
    q.submit(make_spec("ok", cmd=sleeper_cmd(0.1, tmp_path / "done")))
    t0 = time.time()
    rc = Scheduler(q, workers=2, hang_timeout_s=1.0, backoff_s=0.05,
                   log=quiet_log).run()
    assert time.time() - t0 < 30
    assert rc == EXIT_QUARANTINED
    st = q.fold()
    assert st["ok"].state == "done" and st["hung"].state == "quarantined"
    assert any("watchdog" in r["cause"]
               for r in CrashLog(q.crash_log_path("hung")).read())


def test_scheduler_preempt_requeues_and_lock_excludes(tmp_path):
    """SIGTERM-style preemption requeues the running run (not a crash)
    and exits 75; a fresh scheduler completes it. A second scheduler on
    a locked queue is refused."""
    q = Queue(str(tmp_path / "q")).ensure()
    marker = tmp_path / "attempt2"
    body = (f"import os, time, sys; "
            f"sys.exit(0) if os.path.exists({str(marker)!r}) else None; "
            f"open({str(marker)!r}, 'w').write('x'); time.sleep(60)")
    q.submit(make_spec("r", cmd=[sys.executable, "-c", body]))
    sched = Scheduler(q, workers=1, grace_s=2.0, backoff_s=0.05,
                      log=quiet_log)
    timer = threading.Timer(1.0, sched.request_preempt)
    timer.start()
    rc = sched.run()
    timer.cancel()
    assert rc == EXIT_PREEMPTED
    st = q.fold()["r"]
    assert st.state == "queued" and st.crashes == 0 and st.preemptions == 1
    assert Scheduler(q, workers=1, backoff_s=0.05,
                     log=quiet_log).run() == EXIT_DRAINED
    assert q.fold()["r"].state == "done"

    s1 = Scheduler(q, log=quiet_log)
    s1._acquire_lock()
    try:
        with pytest.raises(SchedulerLockError, match="one scheduler"):
            Scheduler(q, log=quiet_log).run()
    finally:
        s1._release_lock()


def test_scheduler_sigkill_recovery_cli(tmp_path):
    """SIGKILL ``fleet run`` mid-sweep and restart it: in-flight runs
    are reclaimed (not counted as crashes) and the sweep completes."""
    qdir = tmp_path / "q"

    def fleet(*args, **kw):
        return subprocess.run(
            [sys.executable, "-m", "shadow_tpu_torch", "fleet"]
            + list(args), env=_env(), capture_output=True, text=True,
            **kw)

    for i in range(3):
        r = fleet("submit", str(qdir), "--cmd", "--id", f"s{i}", "--",
                  sys.executable, "-c",
                  "import time; time.sleep(1.5); "
                  f"open({str(tmp_path / f'done{i}')!r}, 'w')")
        assert r.returncode == 0, r.stderr
    p = subprocess.Popen(
        [sys.executable, "-m", "shadow_tpu_torch", "fleet", "run",
         str(qdir), "--workers", "1", "--backoff", "0.05"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    q = Queue(str(qdir))
    deadline = time.time() + 60
    while time.time() < deadline and not any(
            st.state == "running" for st in q.fold().values()):
        time.sleep(0.05)
    assert any(st.state == "running" for st in q.fold().values())
    os.kill(p.pid, signal.SIGKILL)
    p.wait(timeout=30)
    r = fleet("run", str(qdir), "--workers", "2", "--backoff", "0.05",
              timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    st = q.fold()
    assert all(st[f"s{i}"].state == "done" for i in range(3))
    assert all(st[f"s{i}"].crashes == 0 for i in range(3))
    assert sum(st[f"s{i}"].reclaims for i in range(3)) >= 1
    assert all((tmp_path / f"done{i}").exists() for i in range(3))


def test_fleet_cli_submit_status_device_and_refusals(tmp_path):
    """submit parses host counts, copies the XML and stores the
    device; the run and batch children carry ``--device`` and run
    ``python -m shadow_tpu_torch``; managed flags smuggled into a cmd
    or a `--` tail are refused; the children carry ``--aot-cache`` when
    the scheduler serves one, and ``run --prewarm`` without it exits 2;
    Scenario.to_xml round-trips."""
    xml = tmp_path / "scen.xml"
    xml.write_text("""<shadow stoptime="6">
  <topology path="nope.graphml"/>
  <host id="a" quantity="5"><process plugin="phold" starttime="1"/></host>
  <host id="b"><process plugin="phold" starttime="1"/></host>
</shadow>""")
    assert FC._count_hosts(str(xml)) == 6
    qdir = str(tmp_path / "q")
    with redirect_stdout(io.StringIO()):
        assert FC.main(["submit", qdir, str(xml), "--device", "cpu",
                        "--", "--seed", "9"]) == 0
        assert FC.main(["submit", qdir, str(xml), "--id", "grp",
                        "--batch", "g", "--seeds", "1,2",
                        "--device", "cpu"]) == 0
        assert FC.main(["status", qdir]) == 0
    q = Queue(qdir)
    states = q.fold()
    st = states["scen"]
    assert st.spec["hosts"] == 6 and st.spec["args"] == ["--seed", "9"]
    assert st.spec["device"] == "cpu"
    assert os.path.isabs(st.spec["config"])
    assert st.spec["config"] != str(xml)
    argv = build_child_argv(q, st.spec, resume=True)
    assert argv[1:3] == ["-m", "shadow_tpu_torch"]
    assert argv[argv.index("--device") + 1] == "cpu"
    assert argv[-2:] == ["--resume", "latest"]
    members = [states["grp-s1"].spec, states["grp-s2"].spec]
    bargv = build_batch_argv(q, members)
    assert bargv[1:4] == ["-m", "shadow_tpu_torch", "batch"]
    assert bargv[bargv.index("--seeds") + 1] == "1,2"
    assert bargv[bargv.index("--device") + 1] == "cpu"
    with pytest.raises(SystemExit):
        FC.main(["submit", qdir, "--cmd", "--perf", "--", "true"])
    with pytest.raises(SystemExit):
        FC.main(["submit", qdir, str(xml), "--id", "clash", "--",
                 "--digest", "/my/chain.jsonl"])
    with pytest.raises(SystemExit):      # a group keeps one device
        FC.main(["submit", qdir, str(xml), "--id", "grp", "--batch", "g",
                 "--seeds", "3"])
    cache = str(tmp_path / "c")
    argv = build_child_argv(q, st.spec, resume=False, aot_cache=cache)
    assert argv[argv.index("--aot-cache") + 1] == os.path.abspath(cache)
    bargv = build_batch_argv(q, members, aot_cache=cache)
    assert bargv[bargv.index("--aot-cache") + 1] == os.path.abspath(cache)
    r = subprocess.run(
        [sys.executable, "-m", "shadow_tpu_torch", "fleet", "run", qdir,
         "--prewarm"], env=_env(), capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 2 and "--aot-cache" in r.stderr, r.stderr

    scen = Scenario(stop_time=10**9, topology_path="t.graphml",
                    hosts=[HostSpec(id="a", bandwidth_down=1500)])
    with pytest.raises(ValueError, match="whole-KiB"):
        scen.to_xml()
    back = load_xml(load_xml(str(xml)).to_xml())
    assert [(h.id, h.quantity) for h in back.hosts] == [("a", 5), ("b", 1)]


def test_fleet_sweep_and_batch_group_equal_runs_alone(tmp_path):
    """``fleet run --workers 2`` over two port runs and a two-member
    batch group, all ``--device cpu``: every digest chain equals the
    same scenario run alone, and the queue drains with no crash."""
    from shadow_tpu_torch.__main__ import main as cli_main

    phold = tmp_path / "phold.xml"
    phold.write_text(PHOLD_XML)
    qdir = str(tmp_path / "q")
    with redirect_stdout(io.StringIO()):
        for seed in (7, 8):
            assert FC.main(["submit", qdir, str(phold), "--id",
                            f"m{seed}", "--device", "cpu",
                            "--digest-every", "8", "--", "--seed",
                            str(seed), "--engine-caps",
                            PHOLD_CAPS]) == 0
        assert FC.main(["submit", qdir, str(phold), "--batch", "g",
                        "--seeds", "1,2", "--device", "cpu",
                        "--digest-every", "8"]) == 0
    r = subprocess.run(
        [sys.executable, "-m", "shadow_tpu_torch", "fleet", "run", qdir,
         "--workers", "2", "--backoff", "0.05"], env=_env(),
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    q = Queue(qdir)
    st = q.fold()
    assert all(s.state == "done" and s.crashes == 0 for s in st.values())
    alone = {
        "m7": ["--seed", "7", "--engine-caps", PHOLD_CAPS],
        "m8": ["--seed", "8", "--engine-caps", PHOLD_CAPS],
        "phold-s1": ["--seed", "1"],
        "phold-s2": ["--seed", "2"],
    }
    for rid, args in alone.items():
        dg = tmp_path / f"alone-{rid}.jsonl"
        with redirect_stdout(io.StringIO()):
            assert cli_main([str(phold), "--device", "cpu", "--digest",
                             str(dg), "--digest-every", "8"] + args) == 0
        assert Path(q.digest_path(rid)).read_bytes() == dg.read_bytes(), (
            f"{rid}: the fleet's chain differs from the run alone")
