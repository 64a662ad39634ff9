"""Whole-run parity of the port's SOCKS chains (client -> relay(s) ->
server fetches over TCP).

tests/test_differential.py's SOCKS shapes — 2 servers, 3 relays and 3
clients, one-hop circuits lossless and two-hop circuits over a 2% loss
link — run through the JAX package and through ``shadow_tpu_torch`` on
the CPU: equal stats, window count and every canonicalized ``Hosts``
field. One EngineConfig shape for both cases.
"""

from shadow_tpu.engine import defs

from test_differential import SOCKS_CFG, _socks_scen
from test_torch_parity import one_torch_thread, run_both  # noqa: F401


def test_socks_one_hop_matches():
    rrep, _ = run_both(_socks_scen(hops=1), SOCKS_CFG)
    assert (rrep.stats[5:, defs.ST_APP_DONE] == 1).all()


def test_socks_multihop_lossy_matches():
    rrep, _ = run_both(_socks_scen(loss=0.02, hops=2, stop=90), SOCKS_CFG)
    assert rrep.stats[:, defs.ST_RETRANSMIT].sum() > 0
    assert rrep.stats[5:, defs.ST_XFER_DONE].sum() > 0
