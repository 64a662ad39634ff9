"""Batch lanes (``shadow_tpu_torch/serving/batch.py`` and
``engine.window.run_windows_batch``): same-shape scenarios stacked
along the row axis must each give exactly their run alone — digest
chain bytes, stats, windows and passes — and the reference's run alone
(``tools/divergence.py`` in stdlib mode exits 0).

The reference runs one shape (16 lossy phold hosts, the differential
caps), so it compiles once for the file; the other cases are the port's
alone.
"""

import dataclasses
import io
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from shadow_tpu.core.config import HostSpec, ProcessSpec, Scenario
from shadow_tpu.engine.sim import Simulation as RefSimulation
from shadow_tpu.engine.state import EngineConfig as RefEngineConfig

from shadow_tpu_torch.core.config import FaultSpec, load_xml
from shadow_tpu_torch.engine.sim import Simulation
from shadow_tpu_torch.engine.state import EngineConfig
from shadow_tpu_torch.hosting import api as hosting
from shadow_tpu_torch.serving import batch as SB

from test_differential import CFG
from test_phold import MESH_TOPO
from test_torch_parity import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
DIVERGENCE = REPO / "tools" / "divergence.py"
PING = REPO / "examples" / "ping.xml"
# the phold mesh with 5% loss on its self-loop
LOSSY_TOPO = MESH_TOPO.replace('<data key="d9">0.0</data>',
                               '<data key="d9">0.05</data>')


def lossy_phold(seed, stop):
    return Scenario(
        stop_time=stop * 10**9, seed=seed, topology_graphml=LOSSY_TOPO,
        hosts=[HostSpec(id="node", quantity=16, processes=[
            ProcessSpec(plugin="phold", start_time=10**9,
                        arguments="port=9000 mean=150ms size=64 "
                                  "init=2")])])


def ping_xml(latency_ms):
    text = PING.read_text()
    return text.replace("<data key=\"d7\">25.0</data>",
                        f"<data key=\"d7\">{latency_ms}</data>")


def test_lossy_phold_lanes_equal_their_runs_and_the_reference(tmp_path):
    """Three lanes of phold-16 at 5% loss, seeds 1-3, the second stopping at
    2 s while the others run to 4 s (it is frozen from then on): each
    lane's chain equals its port run alone and the reference's run
    alone byte for byte, with equal stats, windows and passes; one
    stacked pass steps every lane."""
    stops = {1: 4, 2: 2, 3: 4}
    every = 4
    cfg = EngineConfig(num_hosts=16, **CFG)
    rcfg = RefEngineConfig(num_hosts=16, **CFG)
    alone = {}
    for sd, stop in stops.items():
        RefSimulation(lossy_phold(sd, stop), engine_cfg=rcfg).run(
            digest=str(tmp_path / f"ref{sd}.jsonl"), digest_every=every)
        alone[sd] = Simulation(lossy_phold(sd, stop), engine_cfg=cfg,
                               device="cpu").run(
            digest=str(tmp_path / f"one{sd}.jsonl"), digest_every=every)
    sims = [Simulation(lossy_phold(sd, stop), engine_cfg=cfg, device="cpu")
            for sd, stop in stops.items()]
    reps = SB.run_batch(sims, names=[f"s{sd}" for sd in stops],
                        digest_paths=[str(tmp_path / f"lane{sd}.jsonl")
                                      for sd in stops],
                        digest_every=every)
    for sd, rep in zip(stops, reps):
        lane = (tmp_path / f"lane{sd}.jsonl").read_bytes()
        assert lane == (tmp_path / f"one{sd}.jsonl").read_bytes()
        assert lane == (tmp_path / f"ref{sd}.jsonl").read_bytes()
        one = alone[sd]
        assert (rep.stats == one.stats).all()
        assert (rep.windows, rep.passes, rep.sim_time_ns) == (
            one.windows, one.passes, one.sim_time_ns)
        assert rep.summary()["drop_net"] > 0
    out = subprocess.run([sys.executable, str(DIVERGENCE),
                          str(tmp_path / "ref1.jsonl"),
                          str(tmp_path / "lane1.jsonl")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    stacked = reps[0].batch["stacked_passes"]
    assert max(r.passes for r in reps) <= stacked < sum(r.passes
                                                        for r in reps)
    assert reps[1].sim_time_ns == 2 * 10**9


def test_ping_lanes_with_different_latencies(tmp_path):
    """Two ping lanes on same-shape topologies whose latencies differ:
    each lane routes through its own tables (RTT 50 ms and 80 ms) with
    its own window width, and equals its run alone."""
    cfg = EngineConfig(num_hosts=2, qcap=64, scap=4, obcap=16,
                       incap=32, txqcap=8, chunk_windows=16)
    scens = [load_xml(ping_xml(25.0)), load_xml(ping_xml(40.0))]
    alone = [Simulation(s, engine_cfg=cfg, device="cpu").run(
        digest=str(tmp_path / f"one{i}.jsonl"), digest_every=4)
        for i, s in enumerate(scens)]
    scens = [load_xml(ping_xml(25.0)), load_xml(ping_xml(40.0))]
    reps = SB.run_batch(
        [Simulation(s, engine_cfg=cfg, device="cpu") for s in scens],
        digest_paths=[str(tmp_path / f"lane{i}.jsonl") for i in range(2)],
        digest_every=4)
    for i, (rep, one) in enumerate(zip(reps, alone)):
        assert ((tmp_path / f"lane{i}.jsonl").read_bytes()
                == (tmp_path / f"one{i}.jsonl").read_bytes())
        assert (rep.stats == one.stats).all()
        assert rep.windows == one.windows
    assert [r.summary()["mean_rtt_us"] for r in reps] == [50000.0,
                                                          80000.0]


class _Idle(hosting.HostedApp):
    """A hosted app that does nothing (makes a member hosted)."""


@pytest.mark.parametrize("why,match", [
    ("engine_config", "different EngineConfig"),
    ("hosted", "hosts real processes"),
    ("faults", "schedules faults"),
    ("pcap", "pcap tracing")])
def test_batch_refuses_members_it_cannot_stack(why, match):
    """A different EngineConfig, a hosted member, a fault schedule and
    pcap tracing each raise BatchShapeError before anything runs."""
    cfg = EngineConfig(num_hosts=2, qcap=64, scap=4, obcap=16,
                       incap=32, txqcap=8)
    scen = load_xml(ping_xml(25.0))
    if why == "engine_config":
        sims = [Simulation(load_xml(ping_xml(25.0)), engine_cfg=cfg,
                           device="cpu"),
                Simulation(scen, device="cpu",
                           engine_cfg=dataclasses.replace(cfg, qcap=32))]
    else:
        if why == "hosted":
            hosting.register("serving-idle", lambda _args: _Idle())
            scen.hosts[1].processes[0].plugin = "hosted:serving-idle"
            scen.hosts[1].processes[0].arguments = ""
        elif why == "faults":
            scen.faults.append(FaultSpec(kind="host_down", at=3 * 10**9,
                                         host="client"))
        else:
            scen.hosts[1].pcap = True
        sims = [Simulation(scen, engine_cfg=cfg, device="cpu")]
    with pytest.raises(SB.BatchShapeError, match=match):
        SB.run_batch(sims)
    assert not any(s._ran for s in sims)


def test_batch_cli_seeds_and_refusals(tmp_path):
    """``batch examples/ping.xml --seeds 1,2,3 --device cpu``: one line
    per member, each member's chain equal to its run alone; --aot-cache
    exits 2 naming B3."""
    d = tmp_path / "dg"
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = SB.main([str(PING), "--seeds", "1,2,3",
                      "--device", "cpu", "--digest-dir", str(d),
                      "--digest-every", "4"])
    assert rc == 0
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith('{"member"')]
    assert [ln.split('"')[3] for ln in lines] == ["ping-s1", "ping-s2",
                                                  "ping-s3"]
    for sd in (1, 2, 3):
        scen = load_xml(str(PING))
        scen.seed = sd
        Simulation(scen, device="cpu").run(
            digest=str(tmp_path / f"one{sd}.jsonl"), digest_every=4)
        assert ((d / f"ping-s{sd}.digest.jsonl").read_bytes()
                == (tmp_path / f"one{sd}.jsonl").read_bytes())
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-m", "shadow_tpu_torch", "batch",
                        "examples/ping.xml", "--device", "cpu",
                        "--aot-cache", str(tmp_path / "c")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 2 and "B3" in r.stderr, r.stderr
