"""Parity of the port's fault injection (``shadow_tpu_torch/engine/
faults.py``) and CPU model (``engine/window.py:step_all_hosts``) with
the JAX package.

tests/test_faults.py's executed schedules (churn and flap, the loss and
latency episodes, the host kill whose RSTs free its TCP peer),
examples/faults-demo.xml through both command lines and
tests/test_cpu_model.py's three shapes run through the reference and
through the port on the CPU: equal stats, windows, fault logs, digest
chains and canonicalized Hosts fields. The fault schedules share one
EngineConfig shape and the CPU-model shapes another, so the reference
compiles once for each.
"""

import contextlib
import io
import json
import os

import numpy as np

from shadow_tpu.__main__ import main as ref_cli
from shadow_tpu.apps.base import (APP_BULK, APP_BULK_SERVER, APP_PING,
                                  APP_PING_SERVER)
from shadow_tpu.core.config import FaultSpec, HostSpec, ProcessSpec, Scenario
from shadow_tpu.engine import defs
from shadow_tpu.engine.sim import Simulation as RefSimulation
from shadow_tpu.engine.state import EngineConfig as RefEngineConfig

from shadow_tpu_torch.__main__ import main as port_cli
from shadow_tpu_torch.engine.sim import Simulation
from shadow_tpu_torch.engine.state import EngineConfig

from test_cpu_model import CFG as CPU_CFG
from test_cpu_model import scen as cpu_scen
from test_faults import PING_TOPOLOGY, ping_scenario
from test_torch_parity import assert_states_equal, ref_state
from test_torch_parity import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = dict(qcap=32, scap=4, obcap=16, incap=32, txqcap=8, chunk_windows=8,
           app_kinds=(APP_PING, APP_PING_SERVER, APP_BULK, APP_BULK_SERVER))


def run_both(make, tmp_path, cfg=CFG):
    """One scenario on the reference and on the port (CPU), digest every
    8 windows -> (ref report, port report, port Simulation). Asserts
    equal stats, windows, fault logs, chains and Hosts fields."""
    n = make().total_hosts()
    ref, port = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    rsim = RefSimulation(make(), engine_cfg=RefEngineConfig(num_hosts=n,
                                                            **cfg))
    rrep = rsim.run(digest=ref, digest_every=8)
    psim = Simulation(make(), engine_cfg=EngineConfig(num_hosts=n, **cfg),
                      device="cpu")
    prep = psim.run(digest=port, digest_every=8)
    assert rsim.cfg.cpu_model == psim.cfg.cpu_model
    assert np.array_equal(rrep.stats, prep.stats), (
        np.argwhere(rrep.stats != prep.stats)[:10])
    assert (rrep.windows, rrep.sim_time_ns) == (prep.windows,
                                                prep.sim_time_ns)
    assert rrep.faults == prep.faults
    assert open(ref, "rb").read() == open(port, "rb").read()
    assert_states_equal(ref_state(rsim), psim.final_hosts.numpy())
    return rrep, prep, psim


def test_churn_and_flap_matches(tmp_path):
    faults = [
        FaultSpec(kind="link_down", at=4 * 10**9, until=6 * 10**9,
                  src="server", dst="client"),
        FaultSpec(kind="host_down", at=7 * 10**9, host="server",
                  until=8 * 10**9),
    ]
    _, r, _ = run_both(lambda: ping_scenario(faults), tmp_path)
    assert [f["kind"] for f in r.faults] == [
        "link_down", "link_up", "host_down", "host_up"]
    assert r.summary()["faults_applied"] == 4
    assert r.stats[0, defs.ST_FAULTS] == 2
    assert r.total(defs.ST_PKTS_DROP_NET) > 0
    assert r.stats[1, defs.ST_RTT_COUNT] < 5


def test_loss_episode_matches(tmp_path):
    faults = [FaultSpec(kind="loss", at=3500 * 10**6, until=5500 * 10**6,
                        rate=1.0, src="server", dst="client")]
    _, r, _ = run_both(lambda: ping_scenario(faults), tmp_path)
    assert r.total(defs.ST_PKTS_DROP_NET) > 0
    assert 0 < r.stats[1, defs.ST_RTT_COUNT] < 5


def test_latency_episode_matches(tmp_path):
    faults = [FaultSpec(kind="latency", at=3500 * 10**6,
                        until=6500 * 10**6, extra_ns=40 * 10**6,
                        src="server", dst="client")]
    _, r, _ = run_both(lambda: ping_scenario(faults), tmp_path)
    assert 50_000 < r.summary()["mean_rtt_us"] < 50_000 + 2 * 40_000
    assert r.stats[1, defs.ST_RTT_COUNT] == 5


def test_host_kill_rst_frees_tcp_peer_matches(tmp_path):
    """The killed server's RST frees the client's socket."""
    def scen():
        return Scenario(
            stop_time=40 * 10**9, topology_graphml=PING_TOPOLOGY,
            hosts=[
                HostSpec(id="server", processes=[
                    ProcessSpec(plugin="bulkserver", start_time=10**9,
                                arguments="port=80")]),
                HostSpec(id="client", processes=[
                    ProcessSpec(plugin="bulk", start_time=2 * 10**9,
                                arguments="peer=server port=80 "
                                          "size=5000000 count=1")])],
            faults=[FaultSpec(kind="host_down", at=4 * 10**9,
                              host="server")])

    _, r, sim = run_both(scen, tmp_path)
    assert r.sim_time_ns == 40 * 10**9 and r.durability["rsts"] == 1
    assert 0 < r.total(defs.ST_BYTES_RECV) < 5_000_000
    assert not sim.final_hosts.sk_used[1].any()


def test_faults_demo_through_both_clis(tmp_path):
    """examples/faults-demo.xml through ``python -m shadow_tpu`` and
    ``python -m shadow_tpu_torch --device cpu``: equal chains; pings in
    [4 s, 6 s) vanish on the dead link, the 7 s ping is lost at the
    dead server, and the pings from 8 s on are answered."""
    xml = os.path.join(ROOT, "examples", "faults-demo.xml")
    ref, port = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert ref_cli([xml, "--summary-json", "--digest", ref]) == 0
        assert port_cli([xml, "--summary-json", "--device", "cpu",
                         "--digest", port]) == 0
    lines = out.getvalue().strip().splitlines()
    s = json.loads(lines[-1])
    assert open(ref, "rb").read() == open(port, "rb").read()
    assert sum(line.startswith("fault applied:") for line in lines) == 4
    # pings at 2, 3, 6, 8 and 9 s answered; 4 and 5 s dropped on the link
    assert (s["faults_applied"], s["drop_net"], s["transfers_done"]) == (
        4, 2, 5)


def cpu_run(tmp_path, **kw):
    prec = kw.pop("precision", None)

    def make():
        s = cpu_scen(**kw)
        if prec:
            s.cpu_precision_ns = prec
        return s
    return run_both(make, tmp_path, CPU_CFG)


def test_cpu_model_off_by_default_matches(tmp_path):
    _, r, sim = cpu_run(tmp_path)
    assert not sim.cfg.cpu_model and r.summary()["transfers_done"] == 5


def test_cpu_cost_scales_with_frequency_matches(tmp_path):
    _, r, sim = cpu_run(tmp_path, freq_khz=500_000, precision=1000)
    assert sim.cfg.cpu_model
    assert sim.hp.cpu_cost.tolist() == [60_000, 0]
    assert r.summary()["transfers_done"] == 5


def test_cpu_threshold_blocks_and_recovers_matches(tmp_path):
    """A 1 ms cost per event and a 1 us threshold defer the server's
    events to its CPU horizon: everything completes, later."""
    _, fast, _ = cpu_run(tmp_path, freq_khz=3_000_000, threshold_ns=10**9)
    _, slow, _ = cpu_run(tmp_path, freq_khz=30_000, threshold_ns=1000,
                         precision=1000)
    assert slow.summary()["transfers_done"] == 5
    assert slow.summary()["mean_rtt_us"] > fast.summary()["mean_rtt_us"]
