"""Whole-slice parity on ping: ``examples/ping.xml`` through the JAX
package and through ``shadow_tpu_torch`` on the CPU must give equal
stats, windows and every canonicalized Hosts field; the analytic RTT
(twice the 25 ms self-loop) holds exactly."""

import os

from shadow_tpu.core.config import load_xml as ref_load_xml

from shadow_tpu_torch.core.config import load_xml

from test_torch_parity import ROOT, one_torch_thread, run_both  # noqa: F401


def test_ping_example_matches_reference():
    path = os.path.join(ROOT, "examples", "ping.xml")
    rrep, prep = run_both(lambda: ref_load_xml(path),
                          make_port_scenario=lambda: load_xml(path))
    s = prep.summary()
    assert s["mean_rtt_us"] == 50000
    assert s["transfers_done"] == 5
    assert rrep.summary()["events"] == s["events"]
