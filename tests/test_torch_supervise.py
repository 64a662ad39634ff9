"""Durability of the port alone: ``python -m shadow_tpu_torch
--until-complete`` survives a SIGKILL (``SHADOW_TPU_CRASH_SIM_NS``) and
ends with the uninterrupted run's digest chain, a preemption request
saves a snapshot that resumes to the same chain, usage errors are not
retried, and no module of the port imports jax or the JAX package.

Nothing here runs the reference (no JAX compile): each run is a fresh
``python -m shadow_tpu_torch --device cpu`` process.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

from shadow_tpu_torch.core.config import load_xml
from shadow_tpu_torch.engine import checkpoint as ck
from shadow_tpu_torch.engine.sim import (Preempted, Simulation,
                                         request_preempt)
from shadow_tpu_torch.engine.state import EngineConfig
from shadow_tpu_torch.engine.supervisor import Supervisor

from test_until_complete import PHOLD_CAPS, PHOLD_XML
from torch_threads import one_torch_thread_everywhere  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

# a host of the phold ring dies at 3 s and restarts at 4.5 s: the crash
# at 4 s lands after a snapshot taken inside the episode
FAULT = "kind=host_down,at=3s,host=node2,until=4.5s"


def run_cli(args, extra_env=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.update(extra_env or {})
    p = subprocess.run([sys.executable, "-m", "shadow_tpu_torch"] + args,
                       env=env, cwd=str(REPO), stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, timeout=timeout)
    return p.returncode, p.stdout.decode(errors="replace")


def cli_args(xml, dg, ck_base, extra=()):
    return [str(xml), "--device", "cpu", "--seed", "7", "--engine-caps",
            PHOLD_CAPS, "--fault", FAULT, "--digest", str(dg),
            "--digest-every", "8", "--checkpoint", str(ck_base),
            "--checkpoint-every", "1"] + list(extra)


def test_until_complete_survives_sigkill(tmp_path):
    xml = tmp_path / "phold.xml"
    xml.write_text(PHOLD_XML)
    dg_a = tmp_path / "a.jsonl"
    rc, out = run_cli(cli_args(xml, dg_a, tmp_path / "ck_a",
                               ["--summary-json"]))
    assert rc == 0, out[-3000:]
    assert json.loads(out.strip().splitlines()[-1])["faults_applied"] == 2

    dg_b, ck_b = tmp_path / "b.jsonl", tmp_path / "ck_b"
    rc, out = run_cli(
        ["--until-complete", "--max-retries", "2", "--retry-backoff",
         "0.1"] + cli_args(xml, dg_b, ck_b),
        extra_env={"SHADOW_TPU_CRASH_SIM_NS": "4000000000",
                   "SHADOW_TPU_CRASH_GUARD": str(tmp_path / "guard")})
    assert rc == 0, out[-3000:]
    recs = Supervisor([], str(ck_b)).read_log()
    assert [r["exit_status"] for r in recs] == [-signal.SIGKILL, 0]
    assert recs[1]["resumed"] and recs[1]["argv"][-2:] == ["--resume",
                                                          "latest"]
    assert dg_a.read_bytes() == dg_b.read_bytes()
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import divergence
    finally:
        sys.path.pop(0)
    assert divergence.main([str(dg_a), str(dg_b)]) == 0


def test_usage_errors_exit_2_and_are_not_retried(tmp_path):
    rc, out = run_cli([str(REPO / "examples" / "ping.xml"),
                       "--until-complete"])
    assert rc == 2 and "--checkpoint" in out
    msgs = []
    sup = Supervisor(["--bogus-flag"], str(tmp_path / "ck"),
                     max_retries=3, backoff_s=0.1, log=msgs.append)
    assert sup.run() == 2
    assert any("not retrying" in m for m in msgs)
    assert len(sup.read_log()) == 1


def test_preempt_saves_and_resumes_to_the_same_chain(tmp_path):
    """request_preempt (the CLI's SIGTERM handler) stops the run at the
    next chunk boundary with a snapshot; resuming it finishes with the
    uninterrupted chain."""
    scen = load_xml(str(REPO / "examples" / "faults-demo.xml"))
    cfg = EngineConfig(num_hosts=2, qcap=16, scap=4, obcap=8, incap=16,
                       chunk_windows=4)
    a = str(tmp_path / "a.jsonl")
    Simulation(scen, engine_cfg=cfg, device="cpu").run(digest=a,
                                                       digest_every=4)
    b, base = str(tmp_path / "b.jsonl"), str(tmp_path / "ck")
    windows = [0]

    def clock(label):
        windows[0] += label == "advance"
        if windows[0] == 10:
            request_preempt()

    with pytest.raises(Preempted) as ei:
        Simulation(load_xml(str(REPO / "examples" / "faults-demo.xml")),
                   engine_cfg=cfg, device="cpu").run(
            clock=clock, digest=b, digest_every=4, checkpoint_path=base,
            checkpoint_every_s=100)
    assert ei.value.saved
    rep = Simulation(load_xml(str(REPO / "examples" / "faults-demo.xml")),
                     engine_cfg=cfg, device="cpu").run(
        digest=b, digest_every=4, resume_from=ck.resolve_latest(base))
    assert rep.summary()["faults_applied"] == 4
    assert open(a, "rb").read() == open(b, "rb").read()


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of shadow_tpu_torch, imported in a fresh process,
    leaves jax and every shadow_tpu module out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys, shadow_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    shadow_tpu_torch.__path__, 'shadow_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'\n"
        "             or k.startswith(('jax.', 'jaxlib'))\n"
        "             or k == 'shadow_tpu' or k.startswith('shadow_tpu.'))\n"
        "print(len(mods), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 40 and bad.strip() == "[]"
