"""Port parity of the front end and the fresh state, plus the whole-run
comparison the slice tests share.

The same scenario goes through the JAX package (the reference, on the
CPU) and through ``shadow_tpu_torch`` on ``device="cpu"``: parsed
scenario, topology tables, DNS and attachment, compiled app words, the
engine config and every field of the freshly built state must be equal.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from shadow_tpu.apps.compile import auto_caps as ref_auto_caps
from shadow_tpu.apps.compile import peak_sockets as ref_peak_sockets
from shadow_tpu.core.config import load_xml as ref_load_xml
from shadow_tpu.engine.sim import Simulation as RefSimulation
from shadow_tpu.engine.sim import auto_engine_config as ref_auto_cfg
from shadow_tpu.engine.state import EngineConfig as RefEngineConfig
from shadow_tpu.engine.window import canonicalize_state
from shadow_tpu.routing.topology import build_topology as ref_build_topology

from shadow_tpu_torch.apps.compile import auto_caps, peak_sockets
from shadow_tpu_torch.core.config import load_xml
from shadow_tpu_torch.engine.sim import Simulation, auto_engine_config
from shadow_tpu_torch.engine.state import EngineConfig
from shadow_tpu_torch.routing.topology import build_topology

from test_phold import phold_scenario

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch ops in every whole-run parity file (which
    imports this fixture): the suite runs the files on parallel
    workers, and the port's CPU runs otherwise spread small ops over
    every core (phold's parity took 4.5 CPU-min in 1.3 min of wall
    with the default pool, 1 CPU-min in 0.9 min with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shadow_configs():
    out = []
    for p in sorted(glob.glob(os.path.join(ROOT, "examples", "*.xml"))):
        try:
            ref_load_xml(p)
        except ValueError:
            continue        # behavior graphs, not simulator configs
        out.append(p)
    return out


def ref_state(sim) -> dict:
    h = sim.final_hosts if hasattr(sim, "final_hosts") else sim.hosts
    return {f: np.asarray(getattr(h, f)) for f in h.__dataclass_fields__}


def assert_states_equal(ref: dict, port: dict):
    """Every Hosts field equal (names, order, dtype, shape, bytes) after
    both sides go through the reference's canonicalize_state."""
    assert list(ref) == list(port)
    a, b = canonicalize_state(ref), canonicalize_state(port)
    bad = [f for f in a
           if a[f].dtype != b[f].dtype or a[f].shape != b[f].shape
           or not np.array_equal(a[f], b[f])]
    assert not bad, f"Hosts fields differ: {bad}"


def run_both(make_scenario, cfg: dict = None, make_port_scenario=None,
             cc_kind: int = None):
    """Run one scenario on the reference and on the port (CPU) ->
    (ref_report, port_report). Asserts equal stats, windows and every
    canonicalized Hosts field. The port takes the reference's Scenario
    objects (the same dataclasses) unless `make_port_scenario` builds
    its own. `cc_kind` sets the congestion control in both Shared
    tables (a runtime scalar: the reference keeps its compile)."""
    n = make_scenario().total_hosts()
    rcfg = RefEngineConfig(num_hosts=n, **cfg) if cfg else None
    pcfg = EngineConfig(num_hosts=n, **cfg) if cfg else None
    rsim = RefSimulation(make_scenario(), engine_cfg=rcfg)
    psim = Simulation((make_port_scenario or make_scenario)(),
                      engine_cfg=pcfg, device="cpu")
    if cc_kind is not None:
        import jax.numpy as jnp
        rsim.sh = rsim.sh.replace(cc_kind=jnp.int32(cc_kind))
        psim.sh.cc_kind.fill_(cc_kind)
    rrep = rsim.run()
    prep = psim.run()
    assert np.array_equal(rrep.stats, prep.stats), (
        np.argwhere(rrep.stats != prep.stats)[:10])
    assert rrep.windows == prep.windows
    assert rrep.sim_time_ns == prep.sim_time_ns
    assert_states_equal(ref_state(rsim), psim.final_hosts.numpy())
    return rrep, prep


@pytest.mark.parametrize("path", shadow_configs(),
                         ids=lambda p: os.path.basename(p))
def test_topology_and_scenario_match(path):
    """Parsed scenario, [V, V] latency/reliability tables, the lookahead
    bound, the auto engine config and the capacity planner equal the
    reference's on every example config."""
    rs, ps = ref_load_xml(path), load_xml(path)
    assert rs.stop_time == ps.stop_time and rs.seed == ps.seed
    assert [(h.id, h.quantity, h.bandwidth_up, h.bandwidth_down,
             [(p.plugin, p.start_time, p.arguments) for p in h.processes])
            for h in rs.hosts] == [
        (h.id, h.quantity, h.bandwidth_up, h.bandwidth_down,
         [(p.plugin, p.start_time, p.arguments) for p in h.processes])
        for h in ps.hosts]
    src = rs.topology_graphml or rs.topology_path
    rt, pt = ref_build_topology(src), build_topology(src)
    assert np.array_equal(rt.latency_ns, pt.latency_ns)
    assert rt.reliability.dtype == pt.reliability.dtype
    assert np.array_equal(rt.reliability, pt.reliability)
    assert rt.min_latency_ns == pt.min_latency_ns
    assert np.array_equal(rt.v_bw_up_bytes, pt.v_bw_up_bytes)
    rc, pc = ref_auto_cfg(rs, rt), auto_engine_config(ps, pt)
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    # the capacity planner sizes queues and outboxes, which change results
    assert ref_peak_sockets(rs) == peak_sockets(ps)
    rcap, rinfo = ref_auto_caps(rs, rc)
    pcap, pinfo = auto_caps(ps, pc)
    assert dataclasses.asdict(rcap) == dataclasses.asdict(pcap)
    assert rinfo == pinfo


def _lossy_mesh(n_vertices=9, seed=5):
    """A random connected lossy graph: Dijkstra paths over several hops,
    per-edge and per-vertex loss, parallel edges."""
    rng = np.random.RandomState(seed)
    nodes = "".join(
        f'<node id="v{i}"><data key="d0">{rng.choice([0.0, 0.01])}</data>'
        f'<data key="d3">{1024 * (i + 1)}</data>'
        f'<data key="d4">{512 * (i + 2)}</data></node>'
        for i in range(n_vertices))
    edges = [(i, i + 1) for i in range(n_vertices - 1)]
    edges += [tuple(rng.randint(0, n_vertices, 2)) for _ in range(12)]
    body = "".join(
        f'<edge source="v{a}" target="v{b}"><data key="d7">'
        f'{rng.randint(1, 60)}.0</data><data key="d9">'
        f'{rng.choice([0.0, 0.02, 0.1])}</data></edge>' for a, b in edges)
    return ('<graphml xmlns="http://graphml.graphdrawing.org/xmlns">'
            '<key attr.name="latency" attr.type="double" for="edge" id="d7"/>'
            '<key attr.name="packetloss" attr.type="double" for="edge" '
            'id="d9"/><key attr.name="packetloss" attr.type="double" '
            'for="node" id="d0"/><key attr.name="bandwidthup" '
            'attr.type="int" for="node" id="d4"/><key '
            'attr.name="bandwidthdown" attr.type="int" for="node" id="d3"/>'
            f'<graph edgedefault="undirected">{nodes}{body}</graph>'
            '</graphml>')


def test_multihop_lossy_topology_matches():
    g = _lossy_mesh()
    rt, pt = ref_build_topology(g), build_topology(g)
    assert np.array_equal(rt.latency_ns, pt.latency_ns)
    assert np.array_equal(rt.reliability, pt.reliability)
    assert rt.min_latency_ns == pt.min_latency_ns


def test_fresh_state_matches():
    """Setup order (attach, DNS, compile_app, make_shared, alloc_hosts,
    WAKE_START pushes): every Hosts field, the HostParams arrays, the
    Shared tables (TCP scalars included) and the resolved engine config
    equal the reference's before any window — for a UDP shape and for
    the TCP bulk and SOCKS shapes, a tgen shape (the Shared tgen tables
    and synchronize slots) and a two-process shape."""
    from conftest import SIMPLE_TOPOLOGY
    from test_differential import _bulk_scen, _socks_scen
    from test_multiproc import _mutual_scen
    from test_tgen import FORK_GRAPH, tgen_scenario

    def scen():
        s = phold_scenario(n=10, stop=3)
        s.topology_graphml = _lossy_mesh()
        return s

    def tgen():
        s = tgen_scenario(SIMPLE_TOPOLOGY)
        s.hosts[1].processes[0].arguments = FORK_GRAPH
        return s

    cfg = dict(qcap=16, scap=4, obcap=8, incap=16, txqcap=8)
    for mk in (scen, _bulk_scen(loss=0.05, size=120_000, count=2),
               _socks_scen(loss=0.02, hops=2), tgen, _mutual_scen):
        _fresh_state_equal(mk, cfg)


def _fresh_state_equal(scen, cfg):
    n = scen().total_hosts()
    rsim = RefSimulation(scen(), engine_cfg=RefEngineConfig(num_hosts=n,
                                                            **cfg))
    psim = Simulation(scen(), engine_cfg=EngineConfig(num_hosts=n, **cfg),
                      device="cpu")
    assert_states_equal(ref_state(rsim), psim.hosts.numpy())
    for f in ("hid", "rng_stream", "vertex", "bw_up", "bw_down", "app_kind",
              "app_cfg", "nic_buf", "cpu_cost", "cpu_threshold", "rcvbuf0",
              "sndbuf0", "pcap_on"):
        a = np.asarray(getattr(rsim.hp, f))
        b = getattr(psim.hp, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("lat_ns", "rel", "host_vertex", "host_bw_up", "host_bw_down",
              "seed32", "stop_time", "min_jump", "rng_root", "cc_kind",
              "tcp_init_wnd", "tcp_ssthresh0", "tgen_nodes", "tgen_peers",
              "tgen_pool", "tgen_edges"):
        a = np.asarray(getattr(rsim.sh, f))
        b = getattr(psim.sh, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    rc = dataclasses.asdict(rsim.cfg)
    pc = dataclasses.asdict(psim.cfg)
    assert rc == pc


def test_phase_clock_sees_every_window():
    """run(clock=...) reports drain, exchange and advance once per
    window, in order, and changes no result."""
    labels = []
    sim = Simulation(phold_scenario(n=6, stop=2), device="cpu")
    rep = sim.run(clock=labels.append)
    assert labels == ["drain", "exchange", "advance"] * rep.windows
    plain = Simulation(phold_scenario(n=6, stop=2), device="cpu").run()
    assert np.array_equal(rep.stats, plain.stats)


def test_unported_features_raise():
    """Engine features of later slices raise NotImplementedError naming
    their ROADMAP item. None is left: the CPU model, fault schedules,
    netscope, the packet-trace ring and hosted apps (a hostedcap=4
    config builds a (4, 4) wake ring) all build, and every
    NotImplementedError raised in the port's sources names one."""
    import re
    from shadow_tpu_torch.core.config import FaultSpec
    scen = phold_scenario(n=4, stop=2)
    scen.faults = [FaultSpec(kind="host_down", at=10**9, host="node1")]
    assert Simulation(scen, device="cpu").injector is not None
    sims = {}
    for knobs in (dict(cpu_model=True), dict(netscope=True),
                  dict(tracecap=8), dict(hostedcap=4)):
        sim = Simulation(phold_scenario(n=4, stop=2), device="cpu",
                         engine_cfg=EngineConfig(num_hosts=4, **knobs))
        assert all(getattr(sim.cfg, k) == v for k, v in knobs.items())
        sims.update({k: sim for k in knobs})
    assert sims["tracecap"].hosts.tr_time.shape == (4, 8)
    assert sims["hostedcap"].hosts.hw_time.shape == (4, 4)
    assert sims["hostedcap"].hosting is None
    raised = []
    for path in glob.glob(os.path.join(ROOT, "shadow_tpu_torch", "**",
                                       "*.py"), recursive=True):
        text = open(path).read()
        raised += re.findall(r"raise NotImplementedError\((.*?)\)\n",
                             text, re.S)
    assert all(re.search(r"ROADMAP [A-C]\d+", m) for m in raised), raised


def test_cuda_default_needs_a_card():
    """Entry points default to the card and never fall back quietly."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulation(phold_scenario(n=4, stop=2))

