"""Whole-slice parity on gossip: a ~50-host block-gossip run of 12
sim-s (the first block is mined at 3 s and propagates over several
hops) through the JAX package and ``shadow_tpu_torch`` on the CPU must
give equal stats, windows and every canonicalized Hosts field."""

from test_differential import CFG
from test_gossip import gossip_scenario
from test_torch_parity import one_torch_thread, run_both  # noqa: F401


def test_gossip_matches_reference():
    rrep, prep = run_both(
        lambda: gossip_scenario(n=48, stop=12, fanout=4, interval="2s"), CFG)
    s = prep.summary()
    assert s["transfers_done"] > 0 and 0 < s["mean_rtt_us"] < 1_000_000
