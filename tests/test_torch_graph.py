"""The flow-structured window chunk (``shadow_tpu_torch/core/flow.py``,
``engine/window.py:run_chunk``) on the CPU.

- Under the eager flow the chunk equals the JAX package: the reference
  runs as its own tests run it on the CPU, and the stats, window counts
  and digest chains must be equal, bit for bit (no tolerance), on a
  lossy phold, a lossy gossip, 2-hop lossy SOCKS chains with cubic
  beside tgen web clients and a server host running a tgen server
  beside its bulk server (``_cbrt_where``, the tgen walk, two processes
  a host), and the CPU model's blocked-threshold shape.
- The no-host-read guard: each of those chunks also runs on the
  ``meta`` device under ``core.flow.TraceFlow`` (every body once, as a
  CUDA graph capture records it) and under a TorchFunctionMode that
  raises on any read of a tensor's value on the host, which shows on
  the CPU that the chunk can be captured. The guard is checked live on
  the eager flow's reads.
- The kernels' plain versions (``core/kernels.py``) equal the
  bookkeeping they replace, restated in numpy, on random states.

The reference compiles three shapes: the UDP cells share one
EngineConfig, the TCP cell and the CPU-model cell have their own.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from shadow_tpu.apps.base import APP_GOSSIP, APP_PHOLD
from shadow_tpu.core.config import HostSpec, ProcessSpec, Scenario
from shadow_tpu.engine.sim import Simulation as RefSimulation
from shadow_tpu.engine.state import EngineConfig as RefEngineConfig

from shadow_tpu_torch.__main__ import main as port_cli
from shadow_tpu_torch.core import flow as FL
from shadow_tpu_torch.core import kernels as K
from shadow_tpu_torch.core.simtime import SIMTIME_MAX
from shadow_tpu_torch.engine import window as WN
from shadow_tpu_torch.engine.defs import EV_NULL, N_EVENT_KINDS
from shadow_tpu_torch.engine.sim import Simulation
from shadow_tpu_torch.engine.state import EngineConfig

from test_cpu_model import scen as cpu_scen
from test_differential import LOSSY_TOPO, SOCKS_CFG, _socks_scen
from test_gossip import gossip_scenario
from test_tgen import SERVER_GRAPH, WEB_GRAPH
from test_torch_parity import ROOT, one_torch_thread  # noqa: F401

UDP_CFG = dict(num_hosts=8, qcap=16, scap=4, obcap=8, incap=16, txqcap=8,
               chunk_windows=8, app_kinds=(APP_PHOLD, APP_GOSSIP),
               uses_tcp=False)


def _phold():
    return Scenario(stop_time=4 * 10**9, topology_graphml=LOSSY_TOPO,
                    hosts=[HostSpec(id="node", quantity=8, processes=[
                        ProcessSpec(plugin="phold", start_time=10**9,
                                    arguments="port=9000 mean=200ms "
                                              "size=64 init=3")])])


def _gossip():
    return gossip_scenario(n=8, stop=10, fanout=3, interval="2s",
                           topo=LOSSY_TOPO)


def _socks_tgen():
    """The 2-hop lossy SOCKS chains (cubic), with the two bulk servers
    also running tgen servers and two tgen web clients fetching from
    them."""
    s = _socks_scen(loss=0.02, hops=2, stop=16)()
    srv = s.hosts[0]
    srv.processes.append(ProcessSpec(plugin="tgen", start_time=10**9,
                                     arguments=SERVER_GRAPH))
    s.hosts.append(HostSpec(id="web", quantity=2, processes=[
        ProcessSpec(plugin="tgen", start_time=2 * 10**9,
                    arguments=WEB_GRAPH)]))
    return s


def _cpu():
    s = cpu_scen(freq_khz=30_000, threshold_ns=1000)
    s.cpu_precision_ns = 1000
    return s


SHAPES = {
    "phold": (_phold, UDP_CFG),
    "gossip": (_gossip, UDP_CFG),
    "socks-tgen": (_socks_tgen, dict(num_hosts=10, **SOCKS_CFG)),
    "cpu-model": (_cpu, dict(num_hosts=2, qcap=16, scap=4, obcap=8,
                             incap=16, chunk_windows=8)),
}

_READS = {torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.__bool__,
          torch.Tensor.__int__, torch.Tensor.__index__,
          torch.Tensor.__float__, torch.Tensor.numpy, torch.Tensor.cpu,
          torch.Tensor.nonzero, torch.nonzero, torch.Tensor.masked_select,
          torch.masked_select, torch.tensor, torch.as_tensor}


class NoHostRead(TorchFunctionMode):
    """Raises on every way a chunk could read a tensor's value on the
    host, or copy host data in (which a capture cannot record)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _READS and not (func is torch.as_tensor
                                   and torch.is_tensor(args[0])):
            raise AssertionError(f"host read inside the chunk: {func}")
        return func(*args, **(kwargs or {}))


def _meta(tree):
    return dataclasses.replace(tree, **{
        f.name: getattr(tree, f.name).to("meta")
        for f in dataclasses.fields(tree)
        if torch.is_tensor(getattr(tree, f.name))})


def _trace_chunk(sim):
    """The chunk of `sim`'s state, traced on the meta device under the
    guard -> the flow's body count."""
    plan = WN.make_plan(sim.cfg, sim.hp, sim.sh)
    st, hp, sh = _meta(sim.hosts), _meta(sim.hp), _meta(sim.sh)
    W = torch.zeros(K.W_LEN, dtype=torch.int64, device="meta")
    # as before a capture: the tables the handlers build at first use
    WN.prepare_capture(W.device, sim.cfg)
    flow = FL.TraceFlow()
    with torch.inference_mode(), FL.using(flow), NoHostRead():
        WN.run_chunk(st, hp, sh, sim.cfg, plan, W)
    return flow._n


@pytest.mark.parametrize("shape", list(SHAPES))
def test_eager_chunk_matches_reference_and_reads_no_host(shape, tmp_path):
    """Equal stats, windows and digest chains (every 4 windows) with the
    JAX package; the same chunk traced under the guard reads nothing."""
    make, cfg = SHAPES[shape]
    ref, port = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    rrep = RefSimulation(make(), engine_cfg=RefEngineConfig(**cfg)).run(
        digest=ref, digest_every=4)
    psim = Simulation(make(), engine_cfg=EngineConfig(**cfg), device="cpu")
    reads0 = FL.STATS["host_reads"]
    prep = psim.run(digest=port, digest_every=4)
    assert np.array_equal(rrep.stats, prep.stats), (
        np.argwhere(rrep.stats != prep.stats)[:10])
    assert (rrep.windows, rrep.sim_time_ns) == (prep.windows,
                                                prep.sim_time_ns)
    assert open(ref, "rb").read() == open(port, "rb").read()
    assert prep.events > 0 and prep.passes > 0
    ex = prep.execution
    assert ex["path"] == "eager" and ex["reason"] == "device cpu"
    assert ex["captures"] == 0 and ex["replays"] == 0
    # the eager flow reads each pass's flags, the NIC chain's and the
    # windows' predicates: more than one read a chunk
    assert FL.STATS["host_reads"] - reads0 > ex["chunks"]
    assert prep.summary()["path"] == "eager"
    assert psim.cfg.cpu_model == (shape == "cpu-model")
    fresh = Simulation(make(), engine_cfg=EngineConfig(**cfg), device="cpu")
    assert _trace_chunk(fresh) > 3


def test_guard_catches_host_reads():
    """The guard is live: the eager flow's reads, a planted ``.item()``
    and a host-to-device copy each raise under it."""
    make, cfg = SHAPES["phold"]
    sim = Simulation(make(), engine_cfg=EngineConfig(**cfg), device="cpu")
    plan = WN.make_plan(sim.cfg, sim.hp, sim.sh)
    W = WN.window_scalars(0, 10**9, 10**10, 10**7, 2)
    with torch.inference_mode(), NoHostRead():
        with pytest.raises(AssertionError, match="host read"):
            WN.run_chunk(sim.hosts, sim.hp, sim.sh, sim.cfg, plan, W)
        with pytest.raises(AssertionError, match="host read"):
            sim.hosts.eq_next.min().item()
        with pytest.raises(AssertionError, match="host read"):
            torch.tensor([1, 2])


def _pass_flags_np(code, feat, n_codes, n_bits, null, cont_mask, stop_mask):
    present = np.zeros(n_codes, np.int32)
    present[np.unique(code)] = 1
    word = int(np.bitwise_or.reduce(feat)) if feat is not None and len(
        feat) else 0
    bits = [(word >> j) & 1 for j in range(n_bits)]
    live = bool((code != null).any()) or bool(word & cont_mask)
    return list(present) + bits + [int(live and not word & stop_mask)]


def test_pass_flags_plain_matches_the_bitmap():
    """The pass's dispatch bitmap, feature bits and go-on flag, as the
    drain read them from its flags (``set`` of codes present, each part
    any-of, nothing-ready or a hosted pause stops), on random rows."""
    rng = np.random.RandomState(7)
    n_codes = N_EVENT_KINDS + 7 * 11
    for H, p_null, p_bit in ((1, 0.5, 0.3), (64, 0.9, 0.05),
                             (1000, 1.0, 0.001), (300, 0.2, 0.0)):
        code = np.where(rng.rand(H) < p_null, EV_NULL,
                        rng.randint(0, n_codes, H)).astype(np.int32)
        feat = ((rng.rand(H, 12) < p_bit) << np.arange(12)).sum(1).astype(
            np.int32)
        for f, nb, cm, sm in ((feat, 12, 1 << 10, 1 << 11),
                              (None, 0, 0, 0)):
            got = K.pass_flags(torch.from_numpy(code),
                               None if f is None else torch.from_numpy(f),
                               n_codes, nb, EV_NULL, cm, sm)
            assert got.dtype == torch.int32
            assert got.tolist() == _pass_flags_np(code, f, n_codes, nb,
                                                  EV_NULL, cm, sm)
    assert K.LAUNCHES == {"pass_flags": 0, "advance": 0}


def _advance_np(eq_next, ob_next, ob_cnt, W, mode):
    """The run loop's window boundary as the eager loop computed it on
    the host (next_event_time, ob_cnt.sum(), next_wakeup)."""
    W = list(W)
    mq = int(eq_next.min())
    if mode == K.ADV_SHIP:
        W[K.W_OB0] = int(ob_cnt.sum())
        W[K.W_EX] = int(W[K.W_OB0] > 0)
        return W
    if mode == K.ADV_STEP:
        progressed = W[K.W_RAN] or int(ob_cnt.sum()) < W[K.W_OB0]
        nt = min(mq, int(ob_next.min())) if progressed else mq
        W[K.W_WS] = nt
        W[K.W_WE] = SIMTIME_MAX if nt == SIMTIME_MAX else nt + W[K.W_JUMP]
        W[K.W_I] += 1
    ws = W[K.W_WS]
    W[K.W_CONT] = int(W[K.W_I] < W[K.W_MAXW] and ws < W[K.W_STOP]
                      and ws < SIMTIME_MAX)
    W[K.W_WEFF] = min(W[K.W_WE], W[K.W_STOP])
    W[K.W_RAN] = int(mq < W[K.W_WEFF])
    return W


def test_advance_plain_matches_the_eager_advance():
    """Each advance mode equals the eager loop's host arithmetic on
    random queues and outboxes, empty ones and the stop time included."""
    rng = np.random.RandomState(11)
    for H in (1, 7, 500):
        for trial in range(12):
            eq = rng.randint(0, 5 * 10**9, H).astype(np.int64)
            ob = rng.randint(0, 5 * 10**9, H).astype(np.int64)
            eq[rng.rand(H) < (0.5 if trial % 3 else 1.0)] = SIMTIME_MAX
            ob[rng.rand(H) < (0.5 if trial % 2 else 1.0)] = SIMTIME_MAX
            cnt = rng.randint(0, 3, H).astype(np.int32)
            W = [int(v) for v in WN.window_scalars(
                int(rng.randint(0, 4 * 10**9)), 0,
                int(rng.choice([3 * 10**9, 6 * 10**9])), 10**7,
                int(rng.randint(1, 4))).tolist()]
            W[K.W_WE] = W[K.W_WS] + 10**7
            W[K.W_I] = int(rng.randint(0, 3))
            W[K.W_RAN], W[K.W_OB0] = int(rng.randint(0, 2)), int(
                rng.randint(0, 2 * H))
            for mode in (K.ADV_OPEN, K.ADV_SHIP, K.ADV_STEP):
                got = K.advance(torch.from_numpy(eq), torch.from_numpy(ob),
                                torch.from_numpy(cnt),
                                torch.tensor(W, dtype=torch.int64), mode)
                assert got.tolist() == _advance_np(eq, ob, cnt, W, mode)


def test_prewarm_on_the_cpu_matches_the_shape_fingerprint(capsys):
    """``--prewarm --device cpu`` captures nothing (no card, nothing to
    build) and prints the fingerprint and chunk ``--shape-fingerprint``
    prints for the same command line, and the reference's scope."""
    xml = f"{ROOT}/examples/ping.xml"
    base = [xml, "--device", "cpu", "--digest", "unused.jsonl",
            "--digest-every", "4"]
    assert port_cli(base + ["--shape-fingerprint"]) == 0
    shape = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_cli(base + ["--prewarm"]) == 0
    warm = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert warm["fingerprint"] == shape["shape_fingerprint"]
    assert warm["chunk"] == shape["chunk"] == 4
    assert warm["captured"] is False and warm["path"] == "eager"
    assert warm["cache_scope"] == (f"run_windows.c4."
                                   f"{shape['shape_fingerprint']}")
    assert warm["shards"] == 1 and warm["native_cache"] == "none"
