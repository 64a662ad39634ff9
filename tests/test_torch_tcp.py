"""Parity of the port's TCP tier: bulk transfers, the NIC's TCP pull
and the TCP front end.

The shapes of tests/test_differential.py's TCP cases (one bulkserver,
one bulk client, 120 kB x 2 over a 20 ms self-loop) run through the
JAX package and through ``shadow_tpu_torch`` on the CPU: equal stats,
window count and every canonicalized ``Hosts`` field
(test_torch_parity.run_both). Every whole-run case has one
EngineConfig shape, so the reference compiles once for the file. The
NIC's TCP pull is held under both qdiscs on random rows, and the
socks10k builders against the tools' originals.
"""

import dataclasses

import pytest
import torch

from shadow_tpu.engine import defs
from shadow_tpu.net import congestion as RCC

from shadow_tpu_torch.engine.sim import Simulation
from test_differential import CFG, _bulk_scen
from test_torch_parity import one_torch_thread, run_both  # noqa: F401



def test_bulk_lossless_matches():
    rrep, _ = run_both(_bulk_scen(loss=0.0, size=120_000, count=2), CFG)
    assert rrep.stats[:, defs.ST_XFER_DONE].sum() == 4
    assert rrep.stats[:, defs.ST_RETRANSMIT].sum() == 0


@pytest.mark.parametrize("cc", [RCC.CC_CUBIC, RCC.CC_RENO, RCC.CC_AIMD],
                         ids=["cubic", "reno", "aimd"])
def test_bulk_lossy_matches(cc):
    """5% loss: handshake retries, SACK recovery, RTO go-back-N, FIN
    retransmission and each congestion-control kind."""
    rrep, _ = run_both(_bulk_scen(loss=0.05, size=120_000, count=2,
                                  stop=90), CFG, cc_kind=cc)
    assert rrep.stats[:, defs.ST_RETRANSMIT].sum() > 0
    assert rrep.stats[:, defs.ST_XFER_DONE].sum() > 0


# --- the NIC's TCP pull under both qdiscs, on random rows -------------------

def _tcp_rows(seed):
    """Random Hosts rows whose TCP sockets want the wire in every way
    tcp_pull serves: control bits, new data, SACK-driven retransmission
    of holes, a first FIN; the transmit ring mostly empty."""
    import numpy as np
    from test_torch_cuda import H, random_state
    rng = np.random.RandomState(seed)
    a = random_state(seed)
    S = a["sk_used"].shape[1]
    K = a["sk_sack_s"].shape[2]
    tcp = rng.rand(H, S) < 0.8
    a["sk_used"] = tcp | a["sk_used"]
    a["sk_proto"] = np.where(tcp, 6, a["sk_proto"]).astype(np.int32)
    a["sk_state"] = np.where(tcp, rng.choice([2, 3, 4, 5, 7, 8, 9], (H, S)),
                             a["sk_state"]).astype(np.int32)
    a["sk_ctl"] = np.where(rng.rand(H, S) < 0.3,
                           rng.randint(0, 32, (H, S)), 0).astype(np.int32)
    una = rng.randint(0, 10**6, (H, S)).astype(np.int64)
    a["sk_snd_una"] = una
    a["sk_snd_nxt"] = una + rng.randint(0, 30000, (H, S))
    a["sk_snd_max"] = a["sk_snd_nxt"] + rng.randint(0, 3000, (H, S))
    a["sk_snd_end"] = a["sk_snd_nxt"] + rng.choice([0, 0, 500, 90000],
                                                   (H, S))
    a["sk_cwnd"] = rng.choice([0.0, 1.0, 10.0, 33.5], (H, S)).astype(
        np.float32)
    a["sk_peer_rwnd"] = rng.choice([1, 5000, 174760], (H, S)).astype(
        np.int64)
    a["sk_close_after"] = rng.rand(H, S) < 0.3
    a["sk_hole_end"] = np.where(rng.rand(H, S) < 0.4,
                                a["sk_snd_max"], 0).astype(np.int64)
    a["sk_rex_nxt"] = una + rng.randint(0, 4000, (H, S))
    s = una[..., None] + 1434 * np.sort(rng.randint(1, 20, (H, S, K)), -1)
    s = s + 1434 * np.arange(K) * 2
    live = rng.rand(H, S, K) < 0.4
    a["sk_sack_s"] = np.where(live, s, -1).astype(np.int64)
    a["sk_sack_e"] = np.where(live, s + 1434, -1).astype(np.int64)
    a["sk_ooo_s"] = np.where(live, s + 100, -1).astype(np.int64)
    a["sk_ooo_e"] = np.where(live, s + 3000, -1).astype(np.int64)
    a["sk_rcv_nxt"] = una - rng.randint(0, 5000, (H, S))
    a["sk_peer_fin"] = np.where(rng.rand(H, S) < 0.3, una, -1)
    a["sk_rtt_seq"] = np.where(rng.rand(H, S) < 0.5, -1, una)
    a["sk_rto"] = rng.choice([200, 1000], (H, S)).astype(np.int64) * 10**6
    a["sk_timer_on"] = rng.rand(H, S) < 0.5
    a["txq_cnt"] = np.where(rng.rand(H) < 0.8, 0, a["txq_cnt"]).astype(
        np.int32)
    a["ob_cnt"] = np.minimum(a["ob_cnt"], a["ob_time"].shape[1] - 1)
    a["nic_rr"] = rng.randint(0, S, H).astype(np.int32)
    return a


@pytest.mark.parametrize("qdisc", [0, 1], ids=["fifo", "rr"])
def test_nic_tcp_pull_matches(qdisc):
    """EV_NIC_TX with TCP sockets wanting the wire: the qdisc's pick
    (least recently served, or round-robin from nic_rr), tcp_pull's
    segment, its state updates and the timer/NIC reschedule."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from shadow_tpu.core import rng as RR
    from shadow_tpu.engine.state import make_shared as ref_make_shared
    from shadow_tpu.net import nic as RNIC
    from shadow_tpu.net import packet as RP
    from shadow_tpu_torch.engine.state import make_shared
    from shadow_tpu_torch.net import nic as NIC
    from test_torch_cuda import H, t
    from test_torch_units import assert_rows, both, expect, random_params
    from test_torch_units import ref_np

    a = _tcp_rows(30 + qdisc)
    rhp, php = random_params(30 + qdisc)
    rng = np.random.RandomState(40 + qdisc)
    m = rng.rand(H) < 0.8
    now = rng.randint(10**6, 10**7, H).astype(np.int64)
    wend = 12 * 10**6
    rsh = ref_make_shared(np.zeros((1, 1), np.int64), np.ones((1, 1)),
                          RR.root_key(1), 10**10, 10**6)
    psh = make_shared(np.zeros((1, 1), np.int64), np.ones((1, 1)), 10**10,
                      10**6, "cpu")
    rh, ph = both(a)
    ref = jax.jit(jax.vmap(lambda r, p, x: RNIC.on_tx(
        r, p, rsh, x, wend, jnp.zeros((RP.PKT_WORDS,), jnp.int32),
        qdisc=qdisc)))(rh, rhp, jnp.asarray(now))
    NIC.on_tx(ph, php, psh, t(m), t(now), wend, qdisc)
    want = expect(ref_np(ref), a, m)
    assert (want["stats"][:, defs.ST_PKTS_SENT]
            > a["stats"][:, defs.ST_PKTS_SENT]).sum() > H // 4
    assert_rows(ph, want)


# --- front end: TCP scenarios build, the socks10k builders -----------------

def test_tcp_scenarios_build():
    """Bulk and SOCKS scenarios no longer raise: they resolve a TCP
    config (uses_tcp) and build on the CPU."""
    from test_differential import _socks_scen
    for mk in (_bulk_scen(loss=0.0, size=1000, count=1),
               _socks_scen(hops=1)):
        sim = Simulation(mk(), device="cpu")
        assert sim.cfg.uses_tcp


def test_socks_builders_match_tools():
    """The port's jax-free copies of the socks10k and tgen-1k builders
    and of the ER topology generator give the tools' GraphML text,
    Scenario fields and EngineConfig."""
    from tools import baseline_configs as TB
    from tools import gen_topology as TG

    from shadow_tpu_torch import baseline_configs as PB

    for kw in (dict(n=300, p=0.5, seed=7), dict(n=12, p=0.3, seed=2),
               dict(n=9, seed=4, latency_range=None, latency=7.5)):
        assert PB.er_topology(**kw) == TG.er_topology(**kw)
    assert PB._plab_or_fallback() == TB._plab_or_fallback()

    def fields(s):
        return (s.stop_time, s.seed, s.topology_graphml, s.topology_path,
                [(h.id, h.quantity, h.bandwidth_up, h.bandwidth_down,
                  [(p.plugin, p.start_time, p.arguments)
                   for p in h.processes]) for h in s.hosts])

    for n, hops in ((10_000, 1), (400, 3)):
        rs = TB.build_socks(n, hops=hops, stop=10, count=0, pause="5s")
        ps = PB.build_socks(n, hops=hops, stop=10, count=0, pause="5s")
        assert fields(rs) == fields(ps)
        assert (dataclasses.asdict(TB.socks_caps(n, scap=96))
                == dataclasses.asdict(PB.socks_caps(n, scap=96)))
    # tgen-1k's builder (bench.py:bench_tgen_tcp) and its caps
    for n, stop in ((1000, 10), (50, 4), (7, 60)):
        assert (fields(TB.build_bulk_1k(n, stop=stop))
                == fields(PB.build_bulk_1k(n, stop=stop)))
    assert (dataclasses.asdict(TB.socks_caps(1000, scap=32))
            == dataclasses.asdict(PB.socks_caps(1000, scap=32)))
    sim = PB.bulk1k(50, stop=4, device="cpu")
    want = TB.socks_caps(50, scap=32)
    assert [getattr(sim.cfg, k) for k in ("qcap", "scap", "obcap", "incap",
                                          "txqcap", "chunk_windows")] == [
        want.qcap, want.scap, want.obcap, want.incap, want.txqcap,
        want.chunk_windows]
    assert int(sim.sh.min_jump) == 10**7 and sim.cfg.app_kinds == (4,)
