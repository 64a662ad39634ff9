"""Batch lanes on the TCP tier (the port alone): lossy bulk lanes with
per-lane network observatories, and tgen lanes reading their own copies
of the behavior-graph tables, each equal to its run alone — digest
chain bytes, stats, windows, passes and netscope stream bytes."""

import dataclasses

from shadow_tpu_torch.__main__ import build_test_scenario
from shadow_tpu_torch.core.config import HostSpec, ProcessSpec, Scenario
from shadow_tpu_torch.engine.sim import Simulation
from shadow_tpu_torch.engine.state import EngineConfig
from shadow_tpu_torch.serving.batch import run_batch

from test_torch_parity import one_torch_thread  # noqa: F401

CFG = dict(qcap=16, scap=4, obcap=8, incap=16, txqcap=8, chunk_windows=8)

LOSSY_POI = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="d7"/>
  <key attr.name="packetloss" attr.type="double" for="edge" id="d9"/>
  <key attr.name="packetloss" attr.type="double" for="node" id="d0"/>
  <key attr.name="bandwidthup" attr.type="int" for="node" id="d4"/>
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="d3"/>
  <graph edgedefault="undirected">
    <node id="poi"><data key="d0">0.0</data>
      <data key="d3">20480</data><data key="d4">10240</data></node>
    <edge source="poi" target="poi"><data key="d7">20.0</data>
      <data key="d9">0.05</data></edge>
  </graph>
</graphml>"""


def lossy_bulk(seed):
    return Scenario(
        stop_time=16 * 10**9, seed=seed, topology_graphml=LOSSY_POI,
        hosts=[
            HostSpec(id="server", processes=[
                ProcessSpec(plugin="bulkserver", start_time=10**9,
                            arguments="port=80")]),
            HostSpec(id="client", quantity=2, processes=[
                ProcessSpec(plugin="bulk", start_time=2 * 10**9,
                            arguments="peer=server port=80 size=120000 "
                                      "count=2 pause=1s")])])


def assert_lanes_equal_alone(tmp_path, make, seeds, cfg, netscope=False):
    alone = {}
    for sd in seeds:
        alone[sd] = Simulation(make(sd), engine_cfg=cfg, device="cpu").run(
            digest=str(tmp_path / f"one{sd}.jsonl"), digest_every=4,
            netscope=str(tmp_path / f"one{sd}.ns") if netscope else None)
    reps = run_batch(
        [Simulation(make(sd), engine_cfg=cfg, device="cpu")
         for sd in seeds],
        digest_paths=[str(tmp_path / f"lane{sd}.jsonl") for sd in seeds],
        digest_every=4,
        netscope_paths=([str(tmp_path / f"lane{sd}.ns") for sd in seeds]
                        if netscope else None))
    for sd, rep in zip(seeds, reps):
        one = alone[sd]
        assert ((tmp_path / f"lane{sd}.jsonl").read_bytes()
                == (tmp_path / f"one{sd}.jsonl").read_bytes())
        assert (rep.stats == one.stats).all()
        assert (rep.windows, rep.passes) == (one.windows, one.passes)
        if netscope:
            assert ((tmp_path / f"lane{sd}.ns").read_bytes()
                    == (tmp_path / f"one{sd}.ns").read_bytes())
            ours = {k: v for k, v in rep.network.items() if k != "path"}
            theirs = {k: v for k, v in one.network.items() if k != "path"}
            assert ours == theirs
    return reps


def test_lossy_bulk_lanes(tmp_path):
    """Two 5%-loss bulk lanes, seeds 1 and 2, with netscope: the loss
    rolls, retransmissions, SACK recovery and cubic windows of each
    lane are its run alone's."""
    cfg = EngineConfig(num_hosts=3, netscope=True, **CFG)
    reps = assert_lanes_equal_alone(tmp_path, lossy_bulk, (1, 2), cfg,
                                    netscope=True)
    for rep in reps:
        s = rep.summary()
        assert s["drop_net"] > 0 and s["retransmits"] > 0
        assert s["transfers_done"] == 8
    assert reps[0].summary()["drop_net"] != reps[1].summary()["drop_net"]


def test_tgen_lanes(tmp_path):
    """Two lanes of the builtin tgen benchmark (one server, two
    clients fetching 18 KiB files), seeds 1 and 2: every tgen table
    read goes to the row's own lane copy."""
    def make(seed):
        scen = build_test_scenario(n_clients=2, stop_s=6)
        scen.seed = seed
        return scen

    cfg = dataclasses.replace(
        Simulation(make(1), device="cpu").cfg, chunk_windows=8)
    reps = assert_lanes_equal_alone(tmp_path, make, (1, 2), cfg)
    assert all(r.summary()["transfers_done"] > 0 for r in reps)
