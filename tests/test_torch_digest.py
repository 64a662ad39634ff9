"""Parity of the port's determinism digest chain (``shadow_tpu_torch/
obs/digest.py``) with the reference's (``shadow_tpu/obs/digest.py``).

The same scenario runs through the JAX package and through the port on
the CPU at digest cadence 1: the two chains must be equal byte for
byte, record by record, and ``tools/divergence.py`` (stdlib mode, as a
subprocess) must call them identical. A port run whose state is
perturbed at one window must be reported at that window and section.
Both whole-run shapes share one EngineConfig shape (four hosts on one
lossy vertex), so the reference compiles once for the file.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from shadow_tpu.apps.base import APP_BULK, APP_BULK_SERVER, APP_PHOLD
from shadow_tpu.core.config import HostSpec, ProcessSpec, Scenario
from shadow_tpu.engine.sim import Simulation as RefSimulation
from shadow_tpu.engine.state import EngineConfig as RefEngineConfig

from shadow_tpu_torch.engine.sim import Simulation
from shadow_tpu_torch.engine.state import EngineConfig

from test_differential import CFG as DIFF_CFG
from test_tcp import bulk_scenario, poi_topology
from test_torch_parity import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIVERGENCE = os.path.join(ROOT, "tools", "divergence.py")

CFG = dict(DIFF_CFG, app_kinds=(APP_PHOLD, APP_BULK, APP_BULK_SERVER))


def lossy_phold():
    return Scenario(
        stop_time=4 * 10**9, topology_graphml=poi_topology(loss=0.05),
        hosts=[HostSpec(id="node", quantity=4, processes=[
            ProcessSpec(plugin="phold", start_time=10**9,
                        arguments="port=9000 mean=150ms size=64 init=2")])])


def lossy_bulk():
    """Three bulk clients of one server over the 5%-loss vertex."""
    return bulk_scenario(poi_topology(loss=0.05), size=60_000, count=1,
                         stop=30, clients=3)


def chains(make_scenario, tmp_path, every=1):
    """Run on both packages with a digest chain -> (ref path, port path,
    ref report, port report)."""
    n = make_scenario().total_hosts()
    ref, port = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    rrep = RefSimulation(make_scenario(), engine_cfg=RefEngineConfig(
        num_hosts=n, **CFG)).run(digest=ref, digest_every=every)
    prep = Simulation(make_scenario(), engine_cfg=EngineConfig(
        num_hosts=n, **CFG), device="cpu").run(digest=port,
                                               digest_every=every)
    return ref, port, rrep, prep


def records(path):
    return [json.loads(line) for line in open(path).read().splitlines()]


def divergence(a, b):
    out = subprocess.run([sys.executable, DIVERGENCE, a, b, "--json"],
                         capture_output=True, text=True, timeout=120)
    return out.returncode, json.loads(out.stdout)


def assert_same_chain(ref, port):
    ra, pa = records(ref), records(port)
    assert len(ra) == len(pa)
    for r, p in zip(ra, pa):
        assert r == p, f"first differing record at window {r['window']}"
    assert open(ref, "rb").read() == open(port, "rb").read()
    mr = json.load(open(ref + ".manifest.json"))
    mp = json.load(open(port + ".manifest.json"))
    for k in ("fingerprint", "seed", "digest_every", "engine_config",
              "host_names", "min_jump_ns", "tcp", "faults"):
        assert mr[k] == mp[k], k


@pytest.fixture(scope="module")
def phold_chains(tmp_path_factory):
    """The lossy phold's chains at cadence 1, once for the file."""
    return chains(lossy_phold, tmp_path_factory.mktemp("phold"))


def test_lossy_phold_chain_matches(phold_chains):
    """Cadence 1: one record per window plus the final one, equal to
    the reference's record by record; divergence.py calls them
    identical."""
    ref, port, rrep, prep = phold_chains
    assert prep.summary()["drop_net"] > 0
    assert np.array_equal(rrep.stats, prep.stats)
    assert_same_chain(ref, port)
    recs = records(port)
    assert len(recs) == prep.windows + 1 and recs[-1]["kind"] == "final"
    assert {"event_queue", "tcp", "nic", "outbox", "rng", "app",
            "stats"} <= set(recs[0]["sections"])
    assert len(recs[0]["hosts"]) == 4
    rc, rep = divergence(ref, port)
    assert rc == 0 and rep["identical"] and rep["records"] == len(recs)


def test_lossy_bulk_chain_matches(tmp_path):
    """A TCP shape (5% loss: retransmits and their recovery) at
    cadence 1."""
    ref, port, rrep, prep = chains(lossy_bulk, tmp_path)
    assert prep.summary()["retransmits"] > 0
    assert np.array_equal(rrep.stats, prep.stats)
    assert_same_chain(ref, port)
    rc, _ = divergence(ref, port)
    assert rc == 0


def test_perturbed_state_is_pinned_to_window_and_section(phold_chains,
                                                        tmp_path):
    """One NIC field of one host bumped after window 5: divergence.py
    exits 1 against the file's unperturbed port chain and names the
    first record after it and the nic section; the per-host digests
    name the host."""
    base = phold_chains[1]
    sim = Simulation(lossy_phold(),
                     engine_cfg=EngineConfig(num_hosts=4, **CFG),
                     device="cpu")
    windows = [0]

    def clock(label):
        if label == "advance":
            windows[0] += 1
            if windows[0] == 5:
                sim.hosts.nic_rr[2] += 1

    bad = str(tmp_path / "bad.jsonl")
    sim.run(clock=clock, digest=bad, digest_every=1)
    rc, rep = divergence(base, bad)
    assert rc == 1 and not rep["identical"]
    div = rep["first_divergence"]
    assert div["window"] == 5 and div["record"] == 4
    assert div["sections"] == ["nic"]
    assert [h["name"] for h in div["hosts"]] == ["node3"]
