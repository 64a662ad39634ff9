"""The port on the card: results equal to the port on the CPU.

These tests need a CUDA device and skip without one (marker ``cuda``).
They import neither jax nor the JAX package, so they run on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

The random batched rows defined here also feed tests/test_torch_units.py.
"""

import itertools
import os

import numpy as np
import pytest
import torch

from shadow_tpu_torch.core import rng as R
from shadow_tpu_torch.core.config import HostSpec, ProcessSpec, Scenario
from shadow_tpu_torch.core.simtime import SIMTIME_MAX
from shadow_tpu_torch.engine import window as W
from shadow_tpu_torch.engine.sim import Simulation
from shadow_tpu_torch.engine.state import (EngineConfig, HostParams, Hosts,
                                           alloc_hosts, make_shared)
from shadow_tpu_torch.net import packet as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 192
CAPS = dict(qcap=12, scap=4, obcap=6, incap=5, txqcap=4)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def random_state(seed: int, udp_only: bool = False) -> dict:
    """Hosts arrays (wide layout) with random live content that keeps
    the engine's invariants: eq_next == min(eq_time), unique eq_seq per
    row (time ties resolve by seq), ob_cnt/txq_cnt within capacity."""
    rng = np.random.RandomState(seed)
    a = alloc_hosts(EngineConfig(num_hosts=H, **CAPS), "cpu").numpy()
    Q, S, O, T = CAPS["qcap"], CAPS["scap"], CAPS["obcap"], CAPS["txqcap"]

    full_rows = rng.rand(H) < 0.1               # some queues are full
    free = (rng.rand(H, Q) < 0.5) & ~full_rows[:, None]
    a["eq_time"] = np.where(free, SIMTIME_MAX,
                            rng.choice([5, 7, 9, 11], (H, Q)) * 10**6)
    a["eq_seq"] = np.argsort(rng.rand(H, Q), axis=1).astype(np.int32)
    a["eq_kind"] = rng.randint(1, 4, (H, Q)).astype(np.int32)
    a["eq_pkt"] = rng.randint(0, 50, (H, Q, P.PKT_WORDS)).astype(np.int32)
    a["eq_ctr"] = (Q + rng.randint(0, 1000, H)).astype(np.int32)
    a["eq_next"] = a["eq_time"].min(axis=1)

    a["sk_used"] = rng.rand(H, S) < 0.7
    protos = [17] if udp_only else [6, 17]
    a["sk_proto"] = np.where(a["sk_used"], rng.choice(protos, (H, S)),
                             0).astype(np.int32)
    a["sk_state"] = np.where(a["sk_proto"] == 6,
                             rng.choice([1, 2, 4], (H, S)), 0).astype(np.int32)
    a["sk_lport"] = rng.choice([80, 81, 9000], (H, S)).astype(np.int32)
    a["sk_rhost"] = rng.choice([-1, -1, 0, 1, 2], (H, S)).astype(np.int32)
    a["sk_rport"] = rng.choice([0, 443, 444], (H, S)).astype(np.int32)
    a["sk_rcv_nxt"] = rng.randint(0, 10**6, (H, S)).astype(np.int64)
    a["sk_snd_end"] = rng.randint(0, 10**6, (H, S)).astype(np.int64)
    a["sk_timer_gen"] = rng.randint(0, 9, (H, S)).astype(np.int32)
    a["sk_last_tx"] = rng.randint(0, 10**9, (H, S)).astype(np.int64)
    a["next_eport"] = rng.choice([10000, 10001, 65534], H).astype(np.int32)

    a["nic_busy"] = rng.randint(0, 2 * 10**7, H).astype(np.int64)
    a["nic_sched"] = rng.rand(H) < 0.3
    a["nic_rx_until"] = rng.randint(0, 2 * 10**7, H).astype(np.int64)
    a["txq_cnt"] = rng.randint(0, T + 1, H).astype(np.int32)
    a["txq_head"] = rng.randint(0, T, H).astype(np.int32)
    tx = rng.randint(0, 50, (H, T, P.PKT_WORDS)).astype(np.int32)
    tx[..., P.FLAGS] = 17
    tx[..., P.LEN] = rng.randint(0, 1500, (H, T))
    tx[..., P.DST] = rng.randint(0, H, (H, T))
    a["txq_pkt"] = tx
    a["pkt_ctr"] = rng.randint(0, 10**6, H).astype(np.int32)

    a["ob_cnt"] = rng.randint(0, O + 1, H).astype(np.int32)
    ob = rng.randint(0, 50, (H, O, P.PKT_WORDS)).astype(np.int32)
    ob[..., P.SRC] = np.arange(H)[:, None]
    ob[..., P.DST] = rng.randint(0, H // 8, (H, O))    # fan-in pressure
    ob[..., P.FLAGS] = rng.choice([17, 6 | P.F_SYN], (H, O))
    ob[..., P.UID] = rng.randint(-2**31, 2**31, (H, O), dtype=np.int64)
    a["ob_pkt"] = ob
    a["ob_time"] = rng.randint(0, 10**7, (H, O)).astype(np.int64)
    a["stats"] = rng.randint(0, 100, a["stats"].shape).astype(np.int64)
    a["app_proc"] = np.zeros(H, np.int32)
    return a


def random_params_np(seed: int) -> dict:
    """HostParams arrays: varied bandwidths and NIC buffers."""
    rng = np.random.RandomState(seed + 1000)
    return dict(
        hid=np.arange(H, dtype=np.int32),
        rng_stream=rng.randint(0, 2**32, H, dtype=np.int64).astype(np.uint32),
        vertex=np.zeros(H, np.int32),
        bw_up=rng.choice([1, 10**5, 10**7], H).astype(np.int64),
        bw_down=rng.choice([1, 10**5, 10**7], H).astype(np.int64),
        app_kind=np.zeros((H, 1), np.int32),
        app_cfg=np.zeros((H, 1, 8), np.int64),
        nic_buf=rng.choice([100, 2000, 1024000], H).astype(np.int64),
        cpu_cost=np.zeros(H, np.int64),
        cpu_threshold=np.full(H, -1, np.int64),
        rcvbuf0=np.full(H, -1, np.int64),
        sndbuf0=np.full(H, -1, np.int64),
        pcap_on=np.zeros(H, bool))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_log1p_f32_cuda_bits_equal_cpu(cuda_device):
    u = (torch.arange(1 << 24, dtype=torch.int64).to(torch.float32)
         * (1.0 / (1 << 24)))
    cpu = R.log1p_f32(-u).view(torch.int32)
    gpu = R.log1p_f32(-u.to(cuda_device)).view(torch.int32).cpu()
    assert torch.equal(cpu, gpu)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [12, 13])
def test_exchange_cuda_equals_cpu(cuda_device, seed):
    a = random_state(seed)
    hp_np = random_params_np(seed)
    V = 3
    rng = np.random.RandomState(seed + 3)
    vertex = rng.randint(0, V, H).astype(np.int32)
    lat = rng.randint(1, 50, (V, V)).astype(np.int64) * 10**6
    rel = rng.choice([1.0, 0.9, 0.5, 0.0], (V, V)).astype(np.float32)
    cfg = EngineConfig(num_hosts=H, **CAPS)
    out = []
    for dev in ("cpu", cuda_device):
        st = Hosts(**{k: t(v).to(dev) for k, v in a.items()})
        hp = HostParams(**{k: t(v).to(dev) for k, v in hp_np.items()})
        sh = make_shared(lat, rel, 10**10, 10**6, dev, seed=seed,
                         host_vertex=vertex)
        W.exchange(st, hp, sh, cfg, seed)
        out.append(st.numpy())
    bad = [f for f in out[0] if not np.array_equal(out[0][f], out[1][f])]
    assert not bad, bad


@pytest.mark.cuda
def test_lossy_phold_cuda_equals_cpu(cuda_device):
    topo = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="d7"/>
  <key attr.name="packetloss" attr.type="double" for="edge" id="d9"/>
  <graph edgedefault="undirected"><node id="poi"/>
    <edge source="poi" target="poi"><data key="d7">25.0</data>
      <data key="d9">0.05</data></edge></graph></graphml>"""
    out = []
    for dev in ("cpu", cuda_device):
        scen = Scenario(stop_time=4 * 10**9, topology_graphml=topo,
                        hosts=[HostSpec(id="n", quantity=32, processes=[
                            ProcessSpec(plugin="phold", start_time=10**9,
                                        arguments="port=9000 mean=150ms "
                                                  "init=2")])])
        sim = Simulation(scen, device=dev, engine_cfg=EngineConfig(
            num_hosts=32, qcap=16, scap=4, obcap=8, incap=16))
        rep = sim.run()
        out.append((rep.stats, sim.final_hosts.numpy()))
    assert out[0][0][:, 3].sum() > 0
    assert np.array_equal(out[0][0], out[1][0])
    bad = [f for f in out[0][1]
           if not np.array_equal(out[0][1][f], out[1][1][f])]
    assert not bad, bad


# --- TCP tier ------------------------------------------------------------

def poi_topology(loss):
    """One vertex, a 20 ms self-loop with `loss` (tests/test_tcp.py)."""
    return f"""<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="d7"/>
  <key attr.name="packetloss" attr.type="double" for="edge" id="d9"/>
  <key attr.name="bandwidthup" attr.type="int" for="node" id="d4"/>
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="d3"/>
  <graph edgedefault="undirected"><node id="poi">
    <data key="d3">20480</data><data key="d4">10240</data></node>
    <edge source="poi" target="poi"><data key="d7">20.0</data>
      <data key="d9">{loss}</data></edge></graph></graphml>"""


def bulk_lossy():
    """tests/test_differential.py:_bulk_scen(loss=0.05, size=120_000,
    count=2)."""
    return Scenario(stop_time=60 * 10**9, topology_graphml=poi_topology(0.05),
                    hosts=[
        HostSpec(id="server", processes=[ProcessSpec(
            plugin="bulkserver", start_time=10**9, arguments="port=80")]),
        HostSpec(id="client", processes=[ProcessSpec(
            plugin="bulk", start_time=2 * 10**9,
            arguments="peer=server port=80 size=120000 count=2 "
                      "pause=1s")])])


def socks_multihop_lossy():
    """tests/test_differential.py:_socks_scen(loss=0.02, hops=2,
    stop=90): 2 servers, 3 relays, 3 clients."""
    return Scenario(stop_time=90 * 10**9, topology_graphml=poi_topology(0.02),
                    hosts=[
        HostSpec(id="server", quantity=2, processes=[ProcessSpec(
            plugin="bulkserver", start_time=10**9, arguments="port=80")]),
        HostSpec(id="relay", quantity=3, processes=[ProcessSpec(
            plugin="socksproxy", start_time=10**9,
            arguments="port=9050 server-port=80 relay-lo=2 relay-hi=5")]),
        HostSpec(id="client", quantity=3, processes=[ProcessSpec(
            plugin="socksclient", start_time=2 * 10**9,
            arguments="proxy-lo=2 proxy-hi=5 proxy-port=9050 server-lo=0 "
                      "server-hi=2 size=30000 count=2 pause=1s hops=2")])])


@pytest.mark.cuda
def test_cbrt_f32_cuda_bits_equal_cpu(cuda_device):
    from shadow_tpu_torch.net.congestion import cbrt_f32
    e = np.random.RandomState(3).uniform(-20, 20, 1 << 22)
    x = torch.from_numpy((2.0 ** e).astype(np.float32))
    cpu = cbrt_f32(x).view(torch.int32)
    gpu = cbrt_f32(x.to(cuda_device)).view(torch.int32).cpu()
    assert torch.equal(cpu, gpu)


@pytest.mark.cuda
@pytest.mark.parametrize("name,make,caps", [
    ("bulk-lossy", bulk_lossy,
     dict(qcap=16, scap=4, obcap=8, incap=16, txqcap=8, chunk_windows=8)),
    ("socks-multihop-lossy", socks_multihop_lossy,
     dict(qcap=32, scap=12, obcap=16, incap=24, txqcap=12,
          chunk_windows=8))])
def test_tcp_cuda_equals_cpu(cuda_device, name, make, caps):
    out = []
    for dev in ("cpu", cuda_device):
        n = make().total_hosts()
        sim = Simulation(make(), device=dev,
                         engine_cfg=EngineConfig(num_hosts=n, **caps))
        rep = sim.run()
        out.append((rep.stats, W.canonicalize_state(sim.final_hosts.numpy())))
    assert out[0][0][:, 8].sum() > 0          # ST_RETRANSMIT: loss bit
    assert np.array_equal(out[0][0], out[1][0])
    bad = [f for f in out[0][1]
           if not np.array_equal(out[0][1][f], out[1][1][f])]
    assert not bad, bad


# --- tgen and multi-process hosts --------------------------------------------

def tgen_lossy():
    """tgen servers, web clients (GETs, drawn pauses) and a bulk client
    (the example graphs) over a 2%-loss link, plus a host running a tgen
    server and a bulk client side by side: 7 hosts, 8 sim-s."""
    ex = os.path.join(ROOT, "examples")
    graph = {k: os.path.join(ex, f"tgen.{k}.graphml.xml")
             for k in ("server", "web", "bulk")}
    return Scenario(stop_time=8 * 10**9, topology_graphml=poi_topology(0.02),
                    hosts=[
        HostSpec(id="server", quantity=2, processes=[ProcessSpec(
            plugin="tgen", start_time=10**9, arguments=graph["server"])]),
        HostSpec(id="web", quantity=2, processes=[ProcessSpec(
            plugin="tgen", start_time=2 * 10**9, arguments=graph["web"])]),
        HostSpec(id="bulk", processes=[ProcessSpec(
            plugin="tgen", start_time=2 * 10**9, arguments=graph["bulk"])]),
        HostSpec(id="combo", processes=[
            ProcessSpec(plugin="tgen", start_time=10**9,
                        arguments=graph["server"]),
            ProcessSpec(plugin="bulk", start_time=2 * 10**9,
                        arguments="peer=peer port=80 size=40000 count=2 "
                                  "pause=1s")]),
        HostSpec(id="peer", processes=[ProcessSpec(
            plugin="bulkserver", start_time=10**9, arguments="port=80")])])


@pytest.mark.cuda
def test_tgen_multiproc_cuda_equals_cpu(cuda_device):
    out = []
    for dev in ("cpu", cuda_device):
        sim = Simulation(tgen_lossy(), device=dev, engine_cfg=EngineConfig(
            num_hosts=7, qcap=32, scap=12, obcap=16, incap=24, txqcap=12,
            chunk_windows=8))
        rep = sim.run()
        out.append((rep.stats, rep.windows,
                    W.canonicalize_state(sim.final_hosts.numpy())))
    assert out[0][0][:, 13].sum() > 0        # ST_XFER_DONE
    assert np.array_equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]
    bad = [f for f in out[0][2]
           if not np.array_equal(out[0][2][f], out[1][2][f])]
    assert not bad, bad


@pytest.mark.cuda
def test_telemetry_cuda_equals_cpu(cuda_device):
    """netscope.observe into all four kinds and the exchange's
    packet-trace ring (tx and rx records, rows that overflow) on the
    card equal the CPU."""
    from types import SimpleNamespace

    from shadow_tpu_torch.obs import netscope as NS
    rng = np.random.RandomState(14)
    vals = rng.randint(-5, 1 << 34, 50_000).astype(np.int64)
    on = rng.rand(vals.size) < 0.7
    hists = []
    for dev in ("cpu", cuda_device):
        st = SimpleNamespace(ns_hist=torch.zeros(
            (vals.size, NS.NS_KINDS, NS.NS_BUCKETS), dtype=torch.int64,
            device=dev))
        for k in range(NS.NS_KINDS):
            NS.observe(st, t(np.roll(on, k)).to(dev), k,
                       t(np.roll(vals, 5 * k)).to(dev))
        hists.append(st.ns_hist.cpu())
    assert torch.equal(*hists) and int(hists[0].sum()) > 0

    TC = 10
    a = random_state(14)
    a["tr_time"] = np.zeros((H, TC), np.int64)
    a["tr_pkt"] = np.zeros((H, TC, P.PKT_WORDS), np.int32)
    a["tr_dir"] = np.zeros((H, TC), np.int32)
    a["tr_cnt"] = rng.randint(0, TC + 1, H).astype(np.int32)
    a["tr_drop"] = np.zeros(H, np.int32)
    hp_np = random_params_np(14)
    hp_np["pcap_on"] = rng.rand(H) < 0.6
    lat = np.full((1, 1), 5 * 10**6, np.int64)
    rel = np.full((1, 1), 0.8, np.float32)
    cfg = EngineConfig(num_hosts=H, tracecap=TC, **CAPS)
    out = []
    for dev in ("cpu", cuda_device):
        st = Hosts(**{k: t(v).to(dev) for k, v in a.items()})
        hp = HostParams(**{k: t(v).to(dev) for k, v in hp_np.items()})
        sh = make_shared(lat, rel, 10**10, 10**6, dev, seed=14,
                         host_vertex=np.zeros(H, np.int32))
        W.exchange(st, hp, sh, cfg, 14)
        out.append(st.numpy())
    bad = [f for f in out[0] if not np.array_equal(out[0][f], out[1][f])]
    assert not bad, bad
    assert out[0]["tr_drop"].sum() > 0


def _on_card(a, dev, offset=0):
    """`a` (or None) on `dev` as a view `offset` elements into a larger
    tensor."""
    if a is None:
        return None
    return t(np.concatenate([np.zeros(offset, a.dtype), a])).to(dev)[offset:]


@pytest.mark.cuda
def test_flow_kernels_equal_plain(cuda_device):
    """The chunk kernels (``csrc/flow.cu``: pass_flags, advance) equal
    their plain versions on the CPU, bit for bit, at the edge row
    counts, contiguous and on views one element in: random, idle and
    end-of-range codes, a stop bit, queues and outboxes at SIMTIME_MAX.
    Codes outside the range, which only the kernel takes, equal the
    numpy restatement. Then 24 executions of each in one captured
    graph, each with its own inputs and outputs, replayed three times:
    a partial or a counter left dirty would show."""
    from shadow_tpu_torch.core import kernels as K
    from torch_kernels_np import (EDGE_ROWS, flag_cases, flag_rows,
                                  pass_flags_np, window_rows,
                                  window_scalars_np)
    dev = cuda_device
    launches = dict(K.LAUNCHES)
    for H in EDGE_ROWS:
        for off in (0, 1):
            for rows in ("random", "idle", "ends", "outside"):
                code, feat = flag_rows(H, rows, seed=H + off)
                for c, f, *rest in flag_cases(code, feat):
                    got = K.pass_flags(_on_card(c, dev, off),
                                       _on_card(f, dev, off), *rest)
                    want = (pass_flags_np(c, f, *rest) if rows == "outside"
                            else K.pass_flags_plain(
                                t(c), _on_card(f, "cpu"), *rest).tolist())
                    assert got.cpu().tolist() == want, (H, off, rows)
            for queues in ("random", "empty", "outboxes"):
                rows_np = window_rows(H, queues, seed=H + off)
                eq, ob, cnt = (_on_card(a, dev, off) for a in rows_np)
                for seed in range(2):
                    W0 = torch.tensor(window_scalars_np(seed, H))
                    for mode in (K.ADV_OPEN, K.ADV_SHIP, K.ADV_STEP):
                        got = K.advance(eq, ob, cnt, W0.to(dev), mode)
                        want = K.advance_plain(*map(t, rows_np),
                                               W0.clone(), mode)
                        assert torch.equal(got.cpu(), want), (H, off, mode)

    cases = []
    for i in range(24):
        H, off, mode = EDGE_ROWS[i % len(EDGE_ROWS)], i % 2, i % 3
        code, feat = flag_rows(H, "random", seed=100 + i)
        c, f, *rest = flag_cases(code, feat)[mode]
        rows_np = window_rows(H, "random", seed=100 + i)
        W0 = torch.tensor(window_scalars_np(i, H))
        cases.append(((c, f, *rest), rows_np, W0, mode, (
            (_on_card(c, dev, off), _on_card(f, dev, off), *rest),
            [_on_card(a, dev, off) for a in rows_np], W0.to(dev))))
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    flags = []
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _, _, _, mode, (fargs, rows, W) in cases:
            flags.append(K.pass_flags(*fargs))
            K.advance(*rows, W, mode)
    for _ in range(3):
        for _, _, W0, _, (_, _, W) in cases:
            W.copy_(W0)
        g.replay()
        torch.cuda.synchronize()
        for got, ((c, f, *rest), rows_np, W0, mode, (_, _, W)) in zip(
                flags, cases):
            assert got.cpu().tolist() == K.pass_flags_plain(
                t(c), _on_card(f, "cpu"), *rest).tolist()
            assert torch.equal(W.cpu(), K.advance_plain(
                *map(t, rows_np), W0.clone(), mode))
    K.LAUNCHES.update(launches)


@pytest.mark.cuda
def test_advance_lanes_equals_plain(cuda_device):
    """advance_lanes (``csrc/flow.cu``) equals advance_lanes_plain bit
    for bit on B = 1, 2, 4 and 7 lanes of 1 to 25,001 rows (4,096 and
    25,000 among them, batch-phold-4096x4's and gossip-100k's lanes),
    random and empty queues, each contiguous and on a view one element
    in, about a third of the lanes frozen, every mode; then 20
    executions in one captured graph, each with its own rows and
    scalars, replayed three times: a ticket or a flag left dirty from
    one execution to the next would show."""
    from shadow_tpu_torch.core import kernels as K
    from torch_kernels_np import lane_scalars_np, window_rows
    dev = cuda_device
    launches = dict(K.LAUNCHES)

    def plain(rows_np, Ws, mode):
        W = torch.tensor(Ws, dtype=torch.int64)
        G = torch.zeros(K.W_LEN + 1, dtype=torch.int64)
        K.advance_lanes_plain(*map(t, rows_np), W, G, mode)
        return W, G

    for B in (1, 2, 4, 7):
        for H in (1, 3, 1025, 4096, 4097, 25_000, 25_001):
            for off, kind in itertools.product((0, 1),
                                               ("random", "empty")):
                rows_np = window_rows(B * H, kind, seed=B * H + off)
                rows = [_on_card(a, dev, off) for a in rows_np]
                for seed in range(2):
                    Ws = lane_scalars_np(B, H, seed)
                    for mode in (K.ADV_OPEN, K.ADV_SHIP, K.ADV_STEP):
                        W = torch.tensor(Ws, dtype=torch.int64).to(dev)
                        G = torch.zeros(K.W_LEN + 1, dtype=torch.int64,
                                        device=dev)
                        K.advance_lanes(*rows, W, G, mode)
                        want = plain(rows_np, Ws, mode)
                        assert torch.equal(W.cpu(), want[0]), (B, H, off)
                        assert torch.equal(G.cpu(), want[1]), (B, H, off)
    cases = []
    for i in range(20):
        B, mode = (1, 2, 4, 7)[i % 4], i % 3
        H = (3, 1025, 4096, 4097, 25_000)[i % 5]
        rows_np = window_rows(B * H, "random", seed=200 + i)
        Ws = lane_scalars_np(B, H, i)
        cases.append((rows_np, Ws, mode, [_on_card(a, dev, i % 2)
                                          for a in rows_np],
                      torch.zeros(B, K.W_LEN, dtype=torch.int64,
                                  device=dev),
                      torch.zeros(K.W_LEN + 1, dtype=torch.int64,
                                  device=dev)))
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _, _, mode, rows, W, G in cases:
            K.advance_lanes(*rows, W, G, mode)
    for _ in range(3):
        for _, Ws, _, _, W, G in cases:
            W.copy_(torch.tensor(Ws, dtype=torch.int64))
            G.zero_()
        g.replay()
        torch.cuda.synchronize()
        for rows_np, Ws, mode, _, W, G in cases:
            want = plain(rows_np, Ws, mode)
            assert torch.equal(W.cpu(), want[0])
            assert torch.equal(G.cpu(), want[1])
    K.LAUNCHES.update(launches)


def _lossy_phold(n, seed, stop_s):
    """`n` phold hosts on one 25 ms self-loop with 5% loss."""
    topo = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="d7"/>
  <key attr.name="packetloss" attr.type="double" for="edge" id="d9"/>
  <graph edgedefault="undirected"><node id="poi"/>
    <edge source="poi" target="poi"><data key="d7">25.0</data>
      <data key="d9">0.05</data></edge></graph></graphml>"""
    return Scenario(stop_time=stop_s * 10**9, seed=seed,
                    topology_graphml=topo,
                    hosts=[HostSpec(id="n", quantity=n, processes=[
                        ProcessSpec(plugin="phold", start_time=10**9,
                                    arguments="port=9000 mean=150ms "
                                              "init=2")])])


def _phold_cfg(n):
    return EngineConfig(num_hosts=n, qcap=16, scap=4, obcap=8, incap=16,
                        chunk_windows=16)


def _chain(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.cuda
def test_batch_lanes_graph_equals_eager_and_cpu(cuda_device, tmp_path):
    """Three lossy phold-16 lanes, the second stopping at 2 s (frozen
    from then on), through ``serving.batch.run_batch`` on the card's
    graph path (one captured graph a chunk, one host read a chunk), on
    its eager path (``graph=False``) and on the CPU: each lane's digest
    chain, stats, windows and passes equal on all three."""
    from shadow_tpu_torch.serving.batch import run_batch
    stops = {1: 4, 2: 2, 3: 4}
    out = {}
    for tag, dev, graph in (("graph", cuda_device, True),
                            ("eager", cuda_device, False),
                            ("cpu", "cpu", True)):
        sims = [Simulation(_lossy_phold(16, sd, stop), device=dev,
                           engine_cfg=_phold_cfg(16))
                for sd, stop in stops.items()]
        paths = [str(tmp_path / f"{tag}{sd}.jsonl") for sd in stops]
        reps = run_batch(sims, digest_paths=paths, digest_every=4,
                         graph=graph)
        out[tag] = (reps, [_chain(p) for p in paths])
    ex = out["graph"][0][0].execution
    assert ex["path"] == "graph" and ex["host_reads_per_chunk"] == 1.0
    assert ex["replays"] == ex["chunks"] and ex["captures"] == 1
    assert out["eager"][0][0].execution["reason"] == "graph=False"
    assert out["cpu"][0][0].execution["reason"] == "device cpu"
    for tag in ("eager", "cpu"):
        assert out[tag][1] == out["graph"][1], tag
        for a, b in zip(out[tag][0], out["graph"][0]):
            assert np.array_equal(a.stats, b.stats), tag
            assert (a.windows, a.passes, a.batch) == (b.windows, b.passes,
                                                      b.batch), tag
    assert out["graph"][0][0].summary()["drop_net"] > 0


@pytest.mark.cuda
def test_one_card_mesh_graph_equals_eager(cuda_device, tmp_path):
    """Lossy phold-13 on eight shards of one card (three padding rows,
    the last shard all padding):
    after ``Simulation.prewarm(mesh=...)`` the run replays the captured
    sharded chunk (no capture of its own, one host read a chunk), and
    gives the eager path's (``graph=False``) and the single run's stats,
    windows, digest chain and the eager path's passes a shard."""
    from shadow_tpu_torch.parallel.shard import make_mesh
    runs = {}
    for tag in ("graph", "eager", "single"):
        sim = Simulation(_lossy_phold(13, 1, 4), device=cuda_device,
                         engine_cfg=_phold_cfg(13))
        mesh = None if tag == "single" else make_mesh(8, "cuda:0")
        chain = str(tmp_path / f"{tag}.jsonl")
        if tag == "graph":
            info = sim.prewarm(mesh=mesh, digest_every=4)
            assert info["captured"] and info["path"] == "graph"
            assert info["cache_scope"].startswith(
                "run_windows_sharded.c4.s8.d0-0-0-0-0-0-0-0.")
        rep = sim.run(mesh=mesh, digest=chain, digest_every=4,
                      graph=tag != "eager")
        runs[tag] = (rep, _chain(chain))
    g, e, s = (runs[k][0] for k in ("graph", "eager", "single"))
    assert g.execution["path"] == "graph" and g.execution["captures"] == 0
    assert g.execution["host_reads_per_chunk"] == 1.0
    assert e.execution["path"] == "eager"
    assert runs["graph"][1] == runs["eager"][1] == runs["single"][1]
    for r in (e, s):
        assert np.array_equal(g.stats, r.stats) and g.windows == r.windows
    assert g.shard_passes == e.shard_passes and g.shard_passes[-1] == 0


@pytest.mark.cuda
def test_two_card_mesh_in_one_process(cuda_device, tmp_path):
    """Four shards over two cards in one process (shard i on cuda:(i %
    2)) run eager, every kernel on its shard's own card, and give the
    single run's stats, windows and chain; a run on cuda:1 while cuda:0
    is current gives them too (the wrappers launch on their tensors'
    card)."""
    from shadow_tpu_torch.parallel.shard import make_mesh
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    runs = []
    for dev, mesh, graph in (("cuda:0", None, True),
                             ("cuda", make_mesh(4, "cuda"), True),
                             ("cuda:1", None, False)):
        chain = str(tmp_path / f"{len(runs)}.jsonl")
        rep = Simulation(_lossy_phold(13, 1, 4), device=dev,
                         engine_cfg=_phold_cfg(13)).run(
            mesh=mesh, digest=chain, digest_every=4, graph=graph)
        runs.append((rep, _chain(chain)))
    assert runs[1][0].execution["reason"] == (
        "a mesh over several cards in one process")
    for rep, chain in runs[1:]:
        assert np.array_equal(rep.stats, runs[0][0].stats)
        assert rep.windows == runs[0][0].windows and chain == runs[0][1]
