"""Parity of the port's network observatory (netscope).

The port's ``observe`` equals ``jax.jit`` of the reference's on random
values and on every bucket edge; its host half (fold, percentiles,
report, ensemble, the stream reader, the metrics publisher) returns
what the reference's returns. One whole run with netscope on holds
every sample site at once — gossip, ping, 2-hop lossy SOCKS, lossy bulk
under cubic and the lossy tgen web walk share a 2%-loss link — through
the JAX package and through ``shadow_tpu_torch`` on the CPU: equal
stats, windows, canonicalized ``Hosts`` fields (``ns_hist`` included),
``SimReport.network`` and netscope JSONL bytes. With netscope off,
``observe`` issues no tensor operation.
"""

import contextlib
import io
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from shadow_tpu.core.config import HostSpec, ProcessSpec, Scenario
from shadow_tpu.engine import defs
from shadow_tpu.engine.sim import Simulation as RefSimulation
from shadow_tpu.engine.state import EngineConfig as RefEngineConfig
from shadow_tpu.obs import metrics as RM
from shadow_tpu.obs import netscope as RN

from shadow_tpu_torch.__main__ import main as port_cli
from shadow_tpu_torch.engine.sim import Simulation
from shadow_tpu_torch.engine.state import EngineConfig
from shadow_tpu_torch.obs import metrics as PM
from shadow_tpu_torch.obs import netscope as PN

from test_tcp import poi_topology
from test_tgen import SERVER_GRAPH, WEB_GRAPH
from test_torch_parity import (ROOT, assert_states_equal,  # noqa: F401
                               one_torch_thread, ref_state)

# the reference's dense drain (no compaction rungs) compiles fastest;
# the port ignores the knob and the reference is bit-identical under
# every setting of it
CFG = dict(qcap=32, scap=12, obcap=16, incap=24, txqcap=12,
           chunk_windows=8, netscope=True, active_block=0)


class _Row:
    """The reference's row handle, as far as ``observe`` uses it."""

    def __init__(self, ns_hist):
        self.ns_hist = ns_hist

    def replace(self, ns_hist):
        return _Row(ns_hist)


def test_observe_matches_reference():
    """Random values and every bucket edge +-1 (negative, zero and past
    the overflow bound too), with random `on`, into all four kinds."""
    rng = np.random.RandomState(11)
    edges = np.array([b + d for b in RN.BOUNDS_US for d in (-1, 0, 1)]
                     + [-(1 << 40), -1, 0, 1 << 31, (1 << 62)])
    vals = np.concatenate([edges, rng.randint(-10, 1 << 33, 4000)]
                          ).astype(np.int64)
    on = rng.rand(vals.size) < 0.8
    H = vals.size
    ref_h = jnp.zeros((H, RN.NS_KINDS, RN.NS_BUCKETS), jnp.int64)
    port = SimpleNamespace(ns_hist=torch.zeros(
        (H, PN.NS_KINDS, PN.NS_BUCKETS), dtype=torch.int64))
    for kind in range(RN.NS_KINDS):
        step = jax.jit(jax.vmap(
            lambda h, v, o, k=kind: RN.observe(_Row(h), k, v, o).ns_hist))
        v = np.roll(vals, kind * 7)
        o = np.roll(on, kind * 3)
        ref_h = step(ref_h, jnp.asarray(v), jnp.asarray(o))
        PN.observe(port, torch.from_numpy(o), kind, torch.from_numpy(v))
    assert np.array_equal(np.asarray(ref_h), port.ns_hist.numpy())
    assert [PN.bucket_of(v) for v in vals] == [RN.bucket_of(v)
                                               for v in vals]
    # with netscope off observe issues no tensor operation at all
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    off = SimpleNamespace(ns_hist=torch.zeros((H, PN.NS_KINDS, 0),
                                              dtype=torch.int64))
    v, o = torch.from_numpy(vals), torch.from_numpy(on)
    with Count():
        PN.observe(off, o, PN.NS_RTT, v)
        assert not PN.on(off)
    assert Count.n == 0


def test_host_half_matches_reference(tmp_path):
    """fold, percentile, kind_summary, report, ensemble, bucket edges,
    the stream reader and the ``net`` metrics section, on random
    per-run tables."""
    rng = np.random.RandomState(5)
    runs = [rng.randint(0, 50, (6, 4, 32)) * (rng.rand(6, 4, 32) < 0.3)
            for _ in range(3)]
    for t in runs + [runs[0][0], np.zeros((2, 4, 32), np.int64)]:
        assert PN.fold(t) == RN.fold(t)
        assert PN.report(t) == RN.report(t)
        for row in PN.fold(t) or []:
            for q in (1, 50, 90, 99, 100):
                assert PN.percentile(row, q) == RN.percentile(row, q)
            assert PN.kind_summary(row) == RN.kind_summary(row)
    assert PN.ensemble(runs) == RN.ensemble(runs)
    assert [PN.bucket_edge_us(i) for i in range(40)] == [
        RN.bucket_edge_us(i) for i in range(40)]
    assert (PN.BOUNDS_US, PN.KIND_NAMES, PN.FORMAT) == (
        RN.BOUNDS_US, RN.KIND_NAMES, RN.FORMAT)
    # the same samples stream the same bytes and read back alike
    paths = []
    for mod, name in ((RN, "ref"), (PN, "port")):
        rec = mod.NetScope(str(tmp_path / f"{name}.jsonl"))
        stats = np.zeros((6, defs.N_STATS), np.int64)
        for w, t in enumerate(runs):
            stats[:, w] += w + 1
            rec.sample(w * 8, w * 10**9, t, stats, conns=w)
        rec.close()
        paths.append(rec.path)
        assert rec.summary() == RN.report(runs[-1])
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    assert PN.read_stream(paths[1]) == RN.read_stream(paths[0])
    snaps = []
    for mod, reg_mod in ((RN, RM), (PN, PM)):
        reg = reg_mod.Registry()
        mod.publish(reg, mod.report(runs[1]))
        snaps.append(reg.snapshot()["net"])
    assert snaps[0] == snaps[1] and snaps[1]


def _p(plugin, start_s, args):
    return ProcessSpec(plugin=plugin, start_time=int(start_s * 10**9),
                       arguments=args)


def mixed_scenario(stop=30):
    """Every sample site in one run over a 2%-loss link: block gossip
    among hosts 0-3, 2-hop SOCKS fetches (targets 4-5, relays 6-8,
    clients 9-11), a bulk client pushing 2 x 120 kB under cubic, a
    pinger, and two tgen web clients walking test_tgen.py's graph."""
    return Scenario(
        stop_time=stop * 10**9, topology_graphml=poi_topology(loss=0.02),
        hosts=[
            HostSpec(id="miner", processes=[_p(
                "gossip", 1, "port=8333 fanout=3 interval=1s miner=1 "
                "size=500 n=4")]),
            HostSpec(id="node", quantity=3, processes=[_p(
                "gossip", 1, "port=8333 fanout=3 interval=1s size=500 "
                "n=4")]),
            HostSpec(id="target", quantity=2, processes=[_p(
                "bulkserver", 1, "port=80")]),
            HostSpec(id="relay", quantity=3, processes=[_p(
                "socksproxy", 1, "port=9050 server-port=80 relay-lo=6 "
                "relay-hi=9")]),
            HostSpec(id="client", quantity=3, processes=[_p(
                "socksclient", 2, "proxy-lo=6 proxy-hi=9 proxy-port=9050 "
                "server-lo=4 server-hi=6 size=30000 count=2 pause=1s "
                "hops=2")]),
            HostSpec(id="bsrv", processes=[_p("bulkserver", 1, "port=80")]),
            HostSpec(id="bcli", processes=[_p(
                "bulk", 2, "peer=bsrv port=80 size=120000 count=2 "
                "pause=1s")]),
            HostSpec(id="psrv", processes=[_p("pingserver", 1,
                                              "port=8000")]),
            HostSpec(id="pcli", processes=[_p(
                "ping", 2, "peer=psrv port=8000 interval=500ms size=100 "
                "count=0")]),
            HostSpec(id="server", quantity=2, processes=[_p(
                "tgen", 1, SERVER_GRAPH)]),
            HostSpec(id="web", quantity=2, processes=[_p(
                "tgen", 2, WEB_GRAPH)]),
        ])


def test_netscope_whole_run_matches(tmp_path):
    """Stats, windows, every canonicalized Hosts field, the network
    report and the JSONL stream equal the reference's, and every kind
    and every app family has samples."""
    n = mixed_scenario().total_hosts()
    rsim = RefSimulation(mixed_scenario(),
                         engine_cfg=RefEngineConfig(num_hosts=n, **CFG))
    psim = Simulation(mixed_scenario(), device="cpu",
                      engine_cfg=EngineConfig(num_hosts=n, **CFG))
    rpath, ppath = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    rrep = rsim.run(netscope=rpath)
    prep = psim.run(netscope=ppath)
    assert np.array_equal(rrep.stats, prep.stats)
    assert rrep.windows == prep.windows
    assert_states_equal(ref_state(rsim), psim.final_hosts.numpy())
    assert open(rpath, "rb").read() == open(ppath, "rb").read()
    rnet, pnet = dict(rrep.network), dict(prep.network)
    assert (rnet.pop("path"), pnet.pop("path")) == (rpath, ppath)
    assert rnet == pnet
    s, rs = prep.summary(), rrep.summary()
    assert all(s[k] == rs[k] for k in ("rtt_p50_us", "rtt_p99_us",
                                       "completion_p99_s"))
    kinds = pnet["kinds"]
    assert all(kinds[k]["count"] > 0 for k in PN.KIND_NAMES)
    # the RTT samples are the ST_RTT_COUNT updates, one for one
    assert kinds["rtt"]["count"] == prep.total(defs.ST_RTT_COUNT)
    done = prep.stats[:, defs.ST_XFER_DONE]
    # gossip nodes, SOCKS clients, the bulk client and pinger, tgen webs
    assert (done[[1, 2, 3, 9, 10, 11, 13, 15, 18, 19]] > 0).all()
    assert prep.total(defs.ST_RETRANSMIT) > 0


def test_netscope_cli_analytic(tmp_path):
    """examples/ping.xml through the port's CLI with --netscope: the
    mean RTT stays exactly 50 ms and its exact p50 is the 65,536 us
    bucket edge (bit_length(50000) = 16); the stream's header is
    self-describing; --metrics grows a net section."""
    ns, mt = str(tmp_path / "ns.jsonl"), str(tmp_path / "m.json")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert port_cli([os.path.join(ROOT, "examples", "ping.xml"),
                         "--device", "cpu", "--summary-json",
                         "--netscope", ns, "--metrics", mt]) == 0
    s = json.loads(out.getvalue().strip().splitlines()[-1])
    assert s["mean_rtt_us"] == 50000
    assert s["rtt_p50_us"] == s["rtt_p99_us"] == 65536
    header, records = PN.read_stream(ns)
    assert header["format"] == RN.FORMAT and records
    assert records[-1]["hist"][PN.NS_RTT][16] == s["transfers_done"]
    net = json.load(open(mt))["net"]
    assert net["rtt.count"] == s["transfers_done"]
    assert net["rtt.bucket"][16] == s["transfers_done"]
