"""The port's mesh (``shadow_tpu_torch/parallel/shard.py``) against its
single run and against the JAX package, on an 8-shard CPU mesh.

tests/test_parallel.py's contract, in the port: a sharded run equals the
single run bit for bit — stats, windows and the digest chain, record
for record — for phold (with and without padding rows), tgen, a faulted
run checkpointed and resumed on a mesh, and hosted apps; and it equals
the reference's single run of the same inputs (phold, tgen, the faulted
run, the hosted apps). The v1 exchange (whole-outbox buckets) and the
default v2 buckets agree; a v2 bucket overflow defers into ST_DEFER_A2A
exactly as the reference's own mesh run on the conftest's 8 virtual CPU
devices does. Snapshots cross between a port mesh and the reference's
single run in both directions. The tolerance is exact equality
throughout.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil

import numpy as np
import pytest

from shadow_tpu.engine import checkpoint as ref_ck
from shadow_tpu.engine.sim import Simulation as RefSimulation
from shadow_tpu.engine.state import EngineConfig as RefEngineConfig
from shadow_tpu.parallel.shard import a2a_bucket_cap as ref_bucket_cap
from shadow_tpu.parallel.shard import make_mesh as ref_make_mesh

from shadow_tpu_torch.__main__ import main as port_cli
from shadow_tpu_torch.__main__ import port_fingerprint
from shadow_tpu_torch.core.config import (FaultSpec, HostSpec, ProcessSpec,
                                          Scenario)
from shadow_tpu_torch.engine import checkpoint as ck
from shadow_tpu_torch.engine.sim import Simulation, auto_engine_config
from shadow_tpu_torch.engine.state import EngineConfig
from shadow_tpu_torch.parallel.shard import a2a_bucket_cap, make_mesh
from shadow_tpu_torch.routing.topology import build_topology

from conftest import SIMPLE_TOPOLOGY
from test_phold import phold_scenario
from test_tgen import tgen_scenario
from test_torch_obs import _norm
from test_torch_parity import assert_states_equal
from test_torch_parity import one_torch_thread  # noqa: F401


def mesh8():
    return make_mesh(8, "cpu")


def _read(path):
    return open(path, "rb").read()


def _port(make, mesh=None, cfg=None, **kw):
    """One port run on the CPU; `cfg` overrides knobs of the automatic
    engine config."""
    scen = make()
    engine_cfg = None
    if cfg:
        topo = build_topology(scen.topology_graphml)
        engine_cfg = dataclasses.replace(auto_engine_config(scen, topo),
                                         **cfg)
    sim = Simulation(scen, engine_cfg=engine_cfg, device="cpu")
    return sim, sim.run(mesh=mesh, **kw)


@pytest.fixture(scope="module")
def ref_phold(tmp_path_factory):
    """The reference's single run of phold-16, 5 sim-s: its report, its
    digest chain (every 8 windows) and its checkpoint store."""
    d = tmp_path_factory.mktemp("ref_phold")
    chain, base = str(d / "ref.jsonl"), str(d / "ck")
    rep = RefSimulation(phold_scenario(n=16, stop=5)).run(
        digest=chain, digest_every=8, checkpoint_path=base,
        checkpoint_every_s=1, checkpoint_keep=8)
    return rep, chain, base


@pytest.fixture(scope="module")
def port_phold():
    """The port's runs of phold-16, 5 sim-s, alone and on an 8-shard
    mesh (its default all-to-all exchange) -> (single, mesh) reports."""
    _, single = _port(lambda: phold_scenario(n=16, stop=5))
    _, sharded = _port(lambda: phold_scenario(n=16, stop=5), mesh8())
    return single, sharded


def test_phold_mesh_matches_single_and_reference(ref_phold, port_phold):
    ref = ref_phold[0]
    single, sharded = port_phold
    assert np.array_equal(ref.stats, single.stats)
    assert np.array_equal(single.stats, sharded.stats)
    assert ref.windows == single.windows == sharded.windows
    assert sharded.shards == 8 and len(sharded.shard_passes) == 8
    assert sharded.passes == sum(sharded.shard_passes)
    assert sharded.summary()["shards"] == 8
    assert len(sharded.occupancy["shards"]["per_shard"]) == 8


def test_phold_mesh_padding(tmp_path):
    """13 hosts on 8 shards: three inert padding rows, the same stats
    and Hosts fields, cut back to 13 rows; metrics.json's ``shards``
    section holds each shard's load."""
    s1, single = _port(lambda: phold_scenario(n=13, stop=3))
    metrics = str(tmp_path / "metrics.json")
    s2, sharded = _port(lambda: phold_scenario(n=13, stop=3), mesh8(),
                        metrics=metrics)
    assert sharded.stats.shape[0] == 13
    assert sharded.mesh == {"processes": 1, "backend": None,
                            "host_staged_bytes": 0}
    sec = json.load(open(metrics))["shards"]
    assert sum(sec["events"]) == single.events and len(sec["events"]) == 8
    assert sec["passes"] == sharded.shard_passes
    assert sec["active_hosts"][-1] == 0 and sec["imbalance"] >= 1.0
    assert np.array_equal(single.stats, sharded.stats)
    assert single.windows == sharded.windows
    assert sharded.shard_passes[-1] == 0        # rows 14, 15 are padding
    assert_states_equal(s1.final_hosts.numpy(), s2.final_hosts.numpy())


def _ref_run(make, chain, cfg=None, **knobs):
    """The reference's single run of `make()` on `cfg` (default: its
    automatic engine config) with `knobs`, digest every 8 windows to
    `chain`."""
    cfg = dataclasses.replace(cfg or RefSimulation(make()).cfg, **knobs)
    rsim = RefSimulation(make(), engine_cfg=cfg)
    return rsim, rsim.run(digest=chain, digest_every=8)


def test_tgen_mesh_matches_single(tmp_path):
    """tgen with the network observatory and tracker heartbeats on: the
    same stats, Hosts fields, netscope stream bytes and heartbeat lines
    (less the columns that measure the process) as the port's single
    run, and the reference's stats, windows and chain."""
    def make():
        return tgen_scenario(SIMPLE_TOPOLOGY, n_web=2, n_bulk=1, stop=20)
    runs = []
    for tag, mesh in (("single", None), ("mesh", mesh8())):
        ns = str(tmp_path / f"{tag}.ns.jsonl")
        chain = str(tmp_path / f"{tag}.jsonl")
        runs.append(_port(make, mesh, cfg=dict(netscope=True), netscope=ns,
                          heartbeat_s=5, digest=chain, digest_every=8)
                    + (_read(ns), _read(chain)))
    (s1, single, ns1, c1), (s2, sharded, ns2, c2) = runs
    ref_chain = str(tmp_path / "ref.jsonl")
    _, ref = _ref_run(make, ref_chain, netscope=True)
    assert single.summary()["transfers_done"] > 0
    assert np.array_equal(ref.stats, sharded.stats)
    assert np.array_equal(single.stats, sharded.stats)
    assert ref.windows == single.windows == sharded.windows
    assert c1 == c2 == _read(ref_chain)
    assert_states_equal(s1.final_hosts.numpy(), s2.final_hosts.numpy())
    assert ns1 == ns2 and single.network == {
        **sharded.network, "path": single.network["path"]}
    assert _norm(single.heartbeats) == _norm(sharded.heartbeats)
    assert len(single.heartbeats) > 4


def _cut_at(store_mod, base, chain, which):
    """The state a kill just after snapshot `which` leaves: the chain one
    record past its stamped position."""
    snap = sorted(store_mod.CheckpointStore(base).snapshots())[which]
    n = int(np.load(snap)["__digest_records__"])
    lines = open(chain).read().splitlines()
    assert n + 1 < len(lines), "snapshot too late for this test"
    with open(chain, "w") as f:
        f.write("\n".join(lines[:n + 1]) + "\n")
    return snap


def test_digest_chain_and_snapshots_cross_packages(ref_phold, tmp_path):
    """The mesh's chain equals the reference's single chain byte for
    byte; a reference snapshot resumes on a port mesh, and a port mesh
    snapshot in the reference, both ending on the same chain."""
    _, ref_chain, ref_base = ref_phold
    chain, base = str(tmp_path / "mesh.jsonl"), str(tmp_path / "ck")
    _, rep = _port(lambda: phold_scenario(n=16, stop=5), mesh8(),
                   digest=chain, digest_every=8, checkpoint_path=base,
                   checkpoint_every_s=1, checkpoint_keep=8)
    assert _read(chain) == _read(ref_chain)
    assert json.load(open(chain + ".manifest.json"))["shards"] == 8
    assert len(rep.durability["saves"]) >= 3

    b = str(tmp_path / "b.jsonl")
    shutil.copy(ref_chain, b)
    snap = _cut_at(ref_ck, ref_base, b, 1)
    _port(lambda: phold_scenario(n=16, stop=5), mesh8(), digest=b,
          digest_every=8, resume_from=snap)
    assert _read(b) == _read(ref_chain)

    snap = _cut_at(ck, base, chain, 1)
    RefSimulation(phold_scenario(n=16, stop=5)).run(
        digest=chain, digest_every=8, resume_from=snap)
    assert _read(chain) == _read(ref_chain)


def test_exchange_v1_matches_v2(port_phold):
    v2 = port_phold[1]
    v1 = _port(lambda: phold_scenario(n=16, stop=5), mesh8(),
               cfg=dict(exchange_a2a=False))[1]
    assert v2.shards == 8
    assert np.array_equal(v1.stats, v2.stats)
    assert v1.windows == v2.windows
    assert v1.summary()["defer_a2a"] == v2.summary()["defer_a2a"] == 0


def test_wire_bytes_and_mesh_keys(tmp_path):
    """v2's exchanged slots stay flat in the shard count where v1's
    (whole-outbox buckets) grow with it (the reference's arithmetic, on
    the port's bucket cap, which equals the reference's); the mesh size reaches the shape key and the
    perf-ledger key; batch lanes refuse a mesh; ``--workers`` runs the
    CLI on a mesh and reports its size."""
    from shadow_tpu.engine.state import EngineConfig as RefEngineConfig
    H, O = 4096, 16
    totals = {}
    for n in (2, 8, 64):
        cfg = EngineConfig(num_hosts=H, obcap=O)
        lcfg = dataclasses.replace(cfg, num_hosts=H // n)
        rcfg = RefEngineConfig(num_hosts=H, obcap=O)
        B = a2a_bucket_cap(cfg, lcfg)
        assert B == ref_bucket_cap(rcfg, dataclasses.replace(
            rcfg, num_hosts=H // n))
        B1 = a2a_bucket_cap(dataclasses.replace(cfg, exchange_a2a=False),
                            lcfg)
        assert B1 == (H // n) * O
        totals[("v1", n)] = n * n * B1
        assert totals[("v1", n)] == n * H * O
        totals[("v2", n)] = n * n * B
        assert totals[("v2", n)] <= 4 * H * O + 64 * n * n
    assert totals[("v1", 64)] == 32 * totals[("v1", 2)]
    assert totals[("v2", 64)] * 10 <= totals[("v1", 64)]
    capped = EngineConfig(num_hosts=H, obcap=O, a2acap=3)
    assert a2a_bucket_cap(capped, dataclasses.replace(
        capped, num_hosts=H // 8)) == 3

    scen = phold_scenario(n=16, stop=5)
    cfg = Simulation(phold_scenario(n=16, stop=5), device="cpu").cfg
    assert port_fingerprint(cfg, scen, None, 4) != \
        port_fingerprint(cfg, scen, None)
    xml = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "ping.xml")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert port_cli([xml, "--device", "cpu", "--shape-fingerprint",
                         "--workers", "4"]) == 0
        assert port_cli([xml, "--device", "cpu", "--summary-json",
                         "--workers", "4"]) == 0
    fp, *_, s = [json.loads(x) for x in out.getvalue().splitlines()
                 if x.startswith("{")]
    assert fp["workers"] == 4 and ".w4." in fp["shape"]
    assert s["shards"] == 4 and s["mean_rtt_us"] == 50000
    with pytest.raises(SystemExit) as e, \
            contextlib.redirect_stderr(io.StringIO()):
        port_cli(["batch", xml, "--seeds", "1,2", "--device", "cpu",
                  "--workers", "2"])
    assert e.value.code == 2


def test_a2a_overflow_matches_reference_mesh(tmp_path):
    """One-slot buckets overflow: the burst tail defers at its source
    (ST_DEFER_A2A > 0), and the port's mesh equals the reference's mesh
    run — stats, windows and chain — not the single run."""
    ref_chain, chain = str(tmp_path / "ref.jsonl"), str(tmp_path / "p.jsonl")
    rsim = RefSimulation(phold_scenario(n=16, stop=5))
    rsim.cfg = dataclasses.replace(rsim.cfg, a2acap=1)
    ref = rsim.run(mesh=ref_make_mesh(8), digest=ref_chain, digest_every=8)
    _, rep = _port(lambda: phold_scenario(n=16, stop=5), mesh8(),
                   cfg=dict(a2acap=1), digest=chain, digest_every=8)
    assert rep.summary()["defer_a2a"] > 0
    assert np.array_equal(ref.stats, rep.stats)
    assert ref.windows == rep.windows
    assert _read(chain) == _read(ref_chain)


def _proc(plugin, start_s, args):
    return ProcessSpec(plugin=plugin, start_time=int(start_s * 10**9),
                       arguments=args)


def _faulted():
    """Pings, a TCP bulk pair and a second ping pair on six hosts (two
    padding rows on 8 shards): a loss episode on the transfer, a
    host_down of the bulk server mid-transfer (its RST frees the
    client's socket, on another shard) and a link_down under the
    pings."""
    return Scenario(
        stop_time=8 * 10**9, topology_graphml=SIMPLE_TOPOLOGY, hosts=[
            HostSpec(id="srv", processes=[_proc("pingserver", 1,
                                                "port=8000")]),
            HostSpec(id="cli", processes=[_proc(
                "ping", 2, "peer=srv port=8000 interval=1s size=64 "
                "count=5")]),
            HostSpec(id="bsrv", processes=[_proc("bulkserver", 1,
                                                 "port=80")]),
            HostSpec(id="bcli", processes=[_proc(
                "bulk", 2, "peer=bsrv port=80 size=300000 count=1")]),
            HostSpec(id="cli2", processes=[_proc(
                "ping", 2, "peer=srv2 port=9 interval=1s size=64 "
                "count=3")]),
            HostSpec(id="srv2", processes=[_proc("pingserver", 1,
                                                 "port=9")])],
        faults=[
            FaultSpec(kind="loss", at=2100 * 10**6, until=2600 * 10**6,
                      rate=0.2, src="bcli", dst="bsrv"),
            FaultSpec(kind="host_down", at=2200 * 10**6, host="bsrv",
                      until=3200 * 10**6),
            FaultSpec(kind="link_down", at=4 * 10**9, until=5 * 10**9,
                      src="srv", dst="cli")])


FAULTED_CFG = dict(num_hosts=6, qcap=32, scap=4, obcap=16, incap=32,
                   txqcap=8, chunk_windows=8)


def test_faults_checkpoint_resume_on_mesh(tmp_path):
    """A faulted run on the mesh equals the port's single run and the
    reference's (stats, chain, fault log); its snapshot inside the
    episodes resumes on a mesh and in a single run, both ending on the
    uninterrupted chain."""
    cfg = EngineConfig(**FAULTED_CFG)
    single_chain = str(tmp_path / "single.jsonl")
    single = Simulation(_faulted(), engine_cfg=cfg, device="cpu").run(
        digest=single_chain, digest_every=8)
    ref_chain = str(tmp_path / "ref.jsonl")
    _, ref = _ref_run(_faulted, ref_chain,
                      cfg=RefEngineConfig(**FAULTED_CFG))
    assert np.array_equal(ref.stats, single.stats)
    assert ref.faults == single.faults and ref.windows == single.windows
    assert _read(ref_chain) == _read(single_chain)
    chain, base = str(tmp_path / "mesh.jsonl"), str(tmp_path / "ck")
    rep = Simulation(_faulted(), engine_cfg=cfg, device="cpu").run(
        mesh=mesh8(), digest=chain, digest_every=8, checkpoint_path=base,
        checkpoint_every_s=0.25, checkpoint_keep=40)
    assert rep.summary()["faults_applied"] == 6
    assert rep.summary()["drop_net"] > 0 and rep.durability["rsts"] >= 1
    assert np.array_equal(single.stats, rep.stats)
    assert single.faults == rep.faults
    assert _read(chain) == _read(single_chain)
    # a snapshot inside the host_down episode, by its schedule position
    # (the loop saves before it applies a boundary's faults)
    snaps = sorted(ck.CheckpointStore(base).snapshots())
    inside = [p for p in snaps
              if 2 <= int(np.load(p)["__fault_idx__"]) <= 3]
    assert inside, [int(np.load(p)["__fault_idx__"]) for p in snaps]
    for mesh in (mesh8(), None):
        b = str(tmp_path / "b.jsonl")
        shutil.copy(chain, b)
        r = Simulation(_faulted(), engine_cfg=cfg, device="cpu").run(
            mesh=mesh, digest=b, digest_every=8, resume_from=inside[0])
        assert np.array_equal(single.stats, r.stats)
        assert _read(b) == _read(single_chain)


def test_hosted_on_mesh(tmp_path):
    """Hosted Python apps (a UDP pinger, a TCP putter, the loopback
    self-channel) on the mesh: the CPU tier runs on the gathered state
    between windows; equal stats, chains (the ``hosted`` section
    included), Hosts fields and what the apps saw, against the port's
    single run and the reference's."""
    import test_torch_hosting  # noqa: F401  (registers the tt-* apps)

    def make():
        return Scenario(
            stop_time=15 * 10**9, topology_graphml=SIMPLE_TOPOLOGY, hosts=[
                HostSpec(id="srv", processes=[_proc("pingserver", 1,
                                                    "port=8000")]),
                HostSpec(id="cli", processes=[_proc(
                    "hosted:tt-pinger", 2, "peer=srv port=8000 count=4 "
                    "interval_s=1 size=64")]),
                HostSpec(id="bsrv", processes=[_proc("bulkserver", 1,
                                                     "port=80")]),
                HostSpec(id="put", processes=[_proc(
                    "hosted:tt-putter", 2, "peer=bsrv port=80 "
                    "size=51200")]),
                HostSpec(id="self", processes=[_proc(
                    "hosted:tt-selfchannel", 2, "30000")])])

    knobs = dict(num_hosts=5, qcap=32, scap=8, obcap=16, incap=32,
                 txqcap=8)
    cfg = EngineConfig(**knobs)
    ref_chain = str(tmp_path / "ref.jsonl")
    rsim, ref = _ref_run(make, ref_chain, cfg=RefEngineConfig(**knobs))
    runs = []
    for tag, mesh in (("single", None), ("mesh", mesh8())):
        sim = Simulation(make(), engine_cfg=cfg, device="cpu")
        chain = str(tmp_path / f"{tag}.jsonl")
        rep = sim.run(mesh=mesh, digest=chain, digest_every=8)
        runs.append((sim, rep, chain,
                     [sim.hosting.apps[i].seen() for i in (1, 3, 4)]))
    (s1, a, ca, seen_a), (s2, b, cb, seen_b) = runs
    assert seen_a[0] == (4, 4) and seen_a[1] == 1
    assert seen_a == seen_b and a.hosted == b.hosted == ref.hosted
    assert seen_a == [rsim.hosting.apps[i].seen() for i in (1, 3, 4)]
    assert np.array_equal(a.stats, b.stats) and a.windows == b.windows
    assert np.array_equal(ref.stats, b.stats) and ref.windows == b.windows
    assert b'"hosted"' in _read(cb).splitlines()[-1]
    assert _read(ca) == _read(cb) == _read(ref_chain)
    assert_states_equal(s1.final_hosts.numpy(), s2.final_hosts.numpy())
