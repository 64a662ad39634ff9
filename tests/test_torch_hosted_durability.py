"""Parity of the port's hosted tier under faults, checkpoints, the CLI
and telemetry with the JAX package.

- ``host_down``/``host_up`` on a host running an unmodified binary
  behind the LD_PRELOAD shim: the child is SIGKILLed and a fresh one
  respawned, and a ``host_down`` on a host running a Python hosted app
  stops its wakes;
- a checkpointed hosted run resumed from a mid-run snapshot's
  ``.hosted`` sidecar (journal replay) ends with the uninterrupted
  run's digest chain;
- a hosted ``<process plugin="hosted:shim">`` XML through both command
  lines prints the same hosted exit lines;
- heartbeats carry the hosted child's ``rss=`` column and the metrics
  snapshot the shim's per-op counts.

Runs go through the reference and the port on the CPU: equal stats,
windows, fault logs, digest chains, ``SimReport.hosted``, Hosts fields
and child output bytes. Every scenario has the same two hosts (a
modeled bulkserver and a hosted client) under the automatic engine
config, so the reference compiles once.
"""

import contextlib
import io
import os
import re
import subprocess

import numpy as np
import pytest

from shadow_tpu import hosting as ref_hosting
from shadow_tpu.__main__ import main as ref_cli
from shadow_tpu.core.config import FaultSpec, HostSpec, ProcessSpec, Scenario
from shadow_tpu.engine import defs
from shadow_tpu.engine.sim import Simulation as RefSimulation

from shadow_tpu_torch import hosting
from shadow_tpu_torch.__main__ import main as port_cli
from shadow_tpu_torch.engine import checkpoint as ck
from shadow_tpu_torch.engine.sim import Simulation
from shadow_tpu_torch.obs import metrics as M

from conftest import SIMPLE_TOPOLOGY
from test_torch_parity import ROOT, assert_states_equal, ref_state
from test_torch_parity import one_torch_thread  # noqa: F401

TRANSFERS, NBYTES = 4, 100_000


class RepeatPutter:
    """A Python hosted app: one TCP put of `size` bytes every
    `every_ms`, `count` times (duck-typed HostedApp)."""

    def __init__(self, args):
        kv = dict(tok.split("=") for tok in args.split())
        self.size, self.count = int(kv["size"]), int(kv["count"])
        self.every = int(kv["every_ms"]) * 10**6
        self.started = self.done = 0

    def on_start(self, os):
        self.on_timer(os, 0)

    def on_timer(self, os, tag):
        os.tcp_connect("server", 8080)
        self.started += 1
        if self.started < self.count:
            os.timer(self.every)

    def on_connected(self, os, sock, **_identity):
        os.write(sock, self.size)
        os.close(sock)

    def on_sent(self, os, sock):
        self.done += 1

    def on_accept(self, os, sock, tag, **_identity):
        pass

    def on_eof(self, os, sock):
        pass

    def on_dgram(self, os, sock, src, sport, nbytes, aux):
        pass


ref_hosting.register("tt-repeat-putter", RepeatPutter)
hosting.register("tt-repeat-putter", RepeatPutter)


@pytest.fixture(scope="module")
def epclient(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bins") / "epclient")
    subprocess.run(["cc", "-O2", "-o", out,
                    os.path.join(ROOT, "examples", "plugins", "epclient.c")],
                   check=True)
    return out


def scen(client_proc, faults=(), stop_s=10):
    return Scenario(
        stop_time=stop_s * 10**9, topology_graphml=SIMPLE_TOPOLOGY,
        hosts=[HostSpec(id="server", processes=[ProcessSpec(
                   plugin="bulkserver", start_time=10**9,
                   arguments="port=8080")]),
               HostSpec(id="client", processes=[client_proc])],
        faults=list(faults))


def shim_client(out, binary):
    return ProcessSpec(plugin="hosted:shim", start_time=2 * 10**9,
                       arguments=f"out={out} cmd={binary} server 8080 "
                                 f"{NBYTES} {TRANSFERS}")


def run_both(make, tmp_path, **run_kw):
    """make(tag) -> Scenario; one reference and one port run (CPU) with
    a digest every 8 windows -> (ref report, port report, port sim).
    Asserts equal stats, windows, fault logs, chains, SimReport.hosted,
    Hosts fields and the children's output bytes."""
    out = {}
    for tag, cls, kw in (("ref", RefSimulation, {}),
                         ("port", Simulation, {"device": "cpu"})):
        sim = cls(make(str(tmp_path / tag)), **kw)
        dg = str(tmp_path / f"{tag}.jsonl")
        rep = sim.run(digest=dg, digest_every=8, **run_kw)
        child = tmp_path / f"{tag}.out"
        out[tag] = (sim, rep, open(dg, "rb").read(),
                    child.read_bytes() if child.exists() else None)
    (rsim, rrep, rdg, rout), (psim, prep, pdg, pout) = out["ref"], out["port"]
    assert np.array_equal(rrep.stats, prep.stats), (
        np.argwhere(rrep.stats != prep.stats)[:10])
    assert (rrep.windows, rrep.sim_time_ns) == (prep.windows,
                                                prep.sim_time_ns)
    assert rrep.faults == prep.faults and rrep.hosted == prep.hosted
    assert rdg == pdg and b'"hosted"' in pdg
    assert_states_equal(ref_state(rsim), psim.final_hosts.numpy())
    assert rout == pout
    return rrep, prep, psim


@pytest.fixture(scope="module")
def shim_runs(epclient, tmp_path_factory):
    """The plain shim client on both packages, once for the file, with
    heartbeats every sim-second and both metrics registries installed
    -> (its directory, ref report, port report, the registries'
    snapshots by package)."""
    from shadow_tpu.obs import metrics as RM
    d = tmp_path_factory.mktemp("shim")
    reg, rreg = M.install(), RM.install()
    try:
        rrep, prep, _ = run_both(lambda t: scen(shim_client(
            t + ".out", epclient)), d, heartbeat_s=1)
        snaps = {"ref": rreg.snapshot(), "port": reg.snapshot()}
    finally:
        M.finish()
        RM.finish()
    return d, rrep, prep, snaps


def test_shim_host_down_and_up_respawns(epclient, tmp_path):
    """The child is SIGKILLed mid-upload at 3 s; at 4 s a fresh one
    starts its uploads over and finishes them."""
    _, rep, _ = run_both(lambda t: scen(
        shim_client(t + ".out", epclient),
        faults=[FaultSpec(kind="host_down", at=3 * 10**9, host="client",
                          until=4 * 10**9)]), tmp_path)
    assert [f["kind"] for f in rep.faults] == ["host_down", "host_up"]
    assert rep.hosted["client"]["clean"] is True
    assert rep.stats[1, defs.ST_FAULTS] == 2
    assert rep.stats[0, defs.ST_XFER_DONE] > TRANSFERS


def test_python_app_host_down(tmp_path):
    """A Python hosted app's host is killed for good at 3 s: its wakes
    stop and the exit record names the fault."""
    _, rep, psim = run_both(lambda t: scen(
        ProcessSpec(plugin="hosted:tt-repeat-putter", start_time=2 * 10**9,
                    arguments="size=20000 count=20 every_ms=200"),
        faults=[FaultSpec(kind="host_down", at=3 * 10**9, host="client")]),
        tmp_path)
    info = rep.hosted["client"]
    assert info["exit_status"] is None and "host_down" in info["cause"]
    assert 0 < psim.hosting.apps[1].started < 20
    assert rep.summary()["hosted_failures"] == 1


def test_checkpoint_resume_from_hosted_sidecar(epclient, shim_runs,
                                              tmp_path):
    """Run B checkpoints every 0.25 sim-s; a fresh Simulation resumes
    from a mid-run snapshot (its child respawned and fast-forwarded by
    journal replay) and ends with run A's chain (A, the file's shim run,
    equals the reference's)."""
    d, _, rep_a, _ = shim_runs
    chain_a = open(d / "port.jsonl", "rb").read()
    base, dg_b = str(tmp_path / "ck"), str(tmp_path / "b.jsonl")
    out_b = str(tmp_path / "b.out")
    Simulation(scen(shim_client(out_b, epclient)), device="cpu").run(
        digest=dg_b, digest_every=8, checkpoint_path=base,
        checkpoint_every_s=0.25, checkpoint_keep=64)
    assert open(dg_b, "rb").read() == chain_a
    snaps = sorted(ck.CheckpointStore(base).snapshots())
    snap = snaps[len(snaps) // 2]
    assert os.path.exists(snap + ".hosted")
    z = np.load(snap)
    n_recs = int(z["__digest_records__"])
    assert bytes(z["__hosted_sha__"]).decode()
    lines = open(dg_b).read().splitlines()
    assert 0 < n_recs < len(lines)
    with open(dg_b, "w") as f:
        f.write("\n".join(lines[:n_recs]) + "\n")
    open(out_b, "w").close()            # a crash also loses stdout
    sim_c = Simulation(scen(shim_client(out_b, epclient)), device="cpu")
    rep_c = sim_c.run(digest=dg_b, digest_every=8, resume_from=snap)
    assert open(dg_b, "rb").read() == chain_a
    assert np.array_equal(rep_c.stats, rep_a.stats)
    assert all(getattr(a, "_journal", None) is None
               for a in sim_c.hosting.apps.values())
    assert f"transfers={TRANSFERS}" in open(out_b).read()


XML = """<shadow stoptime="10">
  <topology><![CDATA[{topo}]]></topology>
  <host id="server"><process plugin="bulkserver" starttime="1"
    arguments="port=8080"/></host>
  <host id="client"><process plugin="hosted:shim" starttime="2"
    arguments="out={out} cmd={cmd} server 8080 {n} {k}"/></host>
</shadow>
"""

_WALL = re.compile(r"^\d+:\d+\.\d+ \[shadow-tpu\] ")


def test_cli_hosted_exit_lines(epclient, tmp_path):
    """The same hosted XML through ``python -m shadow_tpu`` and
    ``python -m shadow_tpu_torch --device cpu``: equal chains, child
    output and hosted exit lines (the wall-clock prefix removed)."""
    got = {}
    for tag, cli, extra in (("ref", ref_cli, []),
                            ("port", port_cli, ["--device", "cpu"])):
        xml = tmp_path / f"{tag}.xml"
        xml.write_text(XML.format(
            topo=SIMPLE_TOPOLOGY.split("?>", 1)[-1], cmd=epclient,
            out=tmp_path / f"{tag}.out", n=NBYTES, k=TRANSFERS))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli([str(xml), "--digest",
                        str(tmp_path / f"{tag}.jsonl")] + extra) == 0
        got[tag] = ([_WALL.sub("", ln) for ln in
                     buf.getvalue().splitlines() if "] hosted " in ln],
                    (tmp_path / f"{tag}.jsonl").read_bytes(),
                    (tmp_path / f"{tag}.out").read_bytes())
    assert got["ref"] == got["port"]
    assert got["port"][0] == [
        "0:00:10.000000000 [message] [main] hosted client: exit_status=0 "
        "cause=exited status=0"]


_MEASURED = re.compile(r",rss=\d+|,dev=\d+|dev-peak-gib=[^,]*,|waste=[^,]*,|"
                       r"maxrss-gib=.*$")


def test_heartbeat_rss_and_shim_metrics(shim_runs):
    """Heartbeats every sim-second (the file's shim run): equal lines
    once the process columns are removed, and the live child's [ram]
    line carries rss=; the shim's per-op counts equal the reference's."""
    _, rrep, prep, snaps = shim_runs
    assert ([_MEASURED.sub("", ln) for ln in rrep.heartbeats]
            == [_MEASURED.sub("", ln) for ln in prep.heartbeats])
    assert any(",client," in ln and ",rss=" in ln
               for ln in prep.heartbeats if "[ram]" in ln)
    ops = snaps["port"]["shim"]["ops"]
    assert ops == snaps["ref"]["shim"]["ops"] and ops["connect"] == TRANSFERS
