"""Whole-slice parity on phold at the differential-test shapes (12
hosts, lossless, lossy, and under queue pressure): the JAX package and
``shadow_tpu_torch`` on the CPU must give equal stats, windows and
every canonicalized Hosts field. Exact, because the port's log1p_f32
reproduces XLA:CPU's float32 log1p bit for bit (ROADMAP C1)."""

from shadow_tpu.core.config import HostSpec, ProcessSpec, Scenario

from test_differential import CFG, LOSSY_TOPO
from test_phold import MESH_TOPO, phold_scenario
from test_torch_parity import one_torch_thread, run_both  # noqa: F401


def test_phold_matches_reference():
    rrep, prep = run_both(lambda: phold_scenario(n=12, stop=4), CFG)
    s = prep.summary()
    assert s["pkts_sent"] > 100 and s["drop_net"] == 0
    # lossless: everything sent is received, up to messages in flight
    assert 0 <= s["pkts_sent"] - s["pkts_recv"] <= 12 * 4


def test_phold_lossy_matches_reference():
    def scen():
        return Scenario(
            stop_time=4 * 10**9,
            topology_graphml=LOSSY_TOPO,
            hosts=[HostSpec(id="node", quantity=12, processes=[
                ProcessSpec(plugin="phold", start_time=10**9,
                            arguments="port=9000 mean=150ms size=64 "
                                      "init=2")])],
        )

    rrep, prep = run_both(scen, CFG)
    assert prep.summary()["drop_net"] > 0


def test_phold_queue_pressure_matches_reference():
    """16 messages per host in 16-slot queues: arrivals defer at the
    source window after window, and windows that run nothing and ship
    nothing take the anti-livelock advance — same caps, so the same
    compiled reference program as the tests above."""
    def scen():
        return Scenario(
            stop_time=2 * 10**9,
            topology_graphml=MESH_TOPO,
            hosts=[HostSpec(id="node", quantity=12, processes=[
                ProcessSpec(plugin="phold", start_time=10**9,
                            arguments="port=9000 mean=20ms size=64 "
                                      "init=16")])],
        )

    rrep, prep = run_both(scen, CFG)
    assert prep.summary()["defer_fanin"] > 1000
