"""Parity of the port's tgen app: the behavior-graph compiler, whole
runs, and the reference's direct-index reads.

The compiled tables of every graph the repo carries equal the JAX
package's. tests/test_differential.py's lossy web shape and
tests/test_tgen.py's fork/synchronize and timeout shapes run through
the JAX package and through ``shadow_tpu_torch`` on the CPU: equal
stats, window count and every canonicalized ``Hosts`` field
(test_torch_parity.run_both), under one engine shape.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.apps import tgen as RT
from shadow_tpu.core.config import HostSpec, ProcessSpec, Scenario
from shadow_tpu.engine import defs
from shadow_tpu.engine.sim import Simulation as RefSimulation
from shadow_tpu.engine.state import HostParams as RefHostParams
from shadow_tpu.engine.state import Hosts as RefHosts
from shadow_tpu.routing.dns import DNS as RefDNS

from shadow_tpu_torch import baseline_configs as PB
from shadow_tpu_torch.apps import tgen as PT
from shadow_tpu_torch.engine.sim import Simulation
from shadow_tpu_torch.routing.dns import DNS

from conftest import SIMPLE_TOPOLOGY
from test_tgen import (BULK_GRAPH, FORK_GRAPH, SERVER_GRAPH, TIMEOUT_GRAPH,
                       WEB_GRAPH)
from test_torch_parity import ROOT, one_torch_thread, run_both  # noqa: F401

# one engine shape for every whole run (tests/test_differential.py's
# tgen caps)
CFG = dict(qcap=24, scap=6, obcap=12, incap=16, txqcap=8, chunk_windows=8)
# a start time past every stop time: the process's graph is compiled
# into the tables, and the process never starts
LATE = 10**12


def _tgen(name, graph, start_s=None, quantity=1):
    start = LATE if start_s is None else start_s * 10**9
    return HostSpec(id=name, quantity=quantity, processes=[
        ProcessSpec(plugin="tgen", start_time=start, arguments=graph)])

def _tables(tab_cls, dns_cls, graphs, names):
    ref_dns = dns_cls()
    for i, name in enumerate(names):
        ref_dns.register(i, name, None)
    tab = tab_cls()
    starts = [tab.compile(g, ref_dns) for g in graphs]
    return starts, tab.arrays(), tab.sync_slots


def _tables_match(graphs, names):
    """Node, peer, pause-pool and edge tables, synchronize slots and
    start indices of `graphs` equal the reference's."""
    rs, rarr, rsync = _tables(RT.TgenTables, RefDNS, graphs, names)
    ps, parr, psync = _tables(PT.TgenTables, DNS, graphs, names)
    assert rs == ps and rsync == psync
    for a, b in zip(rarr, parr):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_tables_of_test_graphs_match():
    """tests/test_tgen.py's graphs in one table (a repeated graph
    compiles once)."""
    _tables_match([SERVER_GRAPH, WEB_GRAPH, BULK_GRAPH, FORK_GRAPH,
                   TIMEOUT_GRAPH, WEB_GRAPH], ["server1", "server2", "dead"])
    for text in ("100 KiB", "1 MiB", "5242880", "1.5 KB", "2 gib"):
        assert RT.parse_size(text) == PT.parse_size(text)


def test_tables_of_example_graphs_match():
    """The examples' graph files, compiled from their paths."""
    examples = sorted(glob.glob(os.path.join(ROOT, "examples",
                                             "tgen.*.graphml.xml")))
    assert len(examples) == 3
    _tables_match(examples, ["server1", "server2"])


def test_tables_of_tgen1k_graphs_match():
    """build_bulk_1k's server, web and bulk graphs at 50 hosts."""
    bulk50 = PB.build_bulk_1k(50)
    _tables_match([p.arguments for h in bulk50.hosts for p in h.processes],
                  [name for _, name, _ in bulk50.expand_hosts()])


def test_nonblocking_cycle_refused_alike():
    """A graph whose cycle never blocks is refused with the reference's
    message."""
    bad = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
      <graph edgedefault="directed">
        <node id="start" />
        <node id="pause"><data key="time">0</data></node>
        <node id="end" />
        <edge source="start" target="pause" />
        <edge source="pause" target="end" />
        <edge source="end" target="pause" />
      </graph>
    </graphml>"""
    msgs = []
    for tab_cls, dns_cls in ((RT.TgenTables, RefDNS), (PT.TgenTables, DNS)):
        with pytest.raises(ValueError, match="cycle never blocks") as e:
            _tables(tab_cls, dns_cls, [bad], ["server1"])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _lossy_web():
    """tests/test_differential.py::test_differential_tgen_web: two tgen
    servers and two web clients over a 3%-loss link. The whole runs
    share one shape (six tgen hosts, the four graphs in the tables), so
    each scenario adds hosts that never start."""
    lossy = SIMPLE_TOPOLOGY.replace('<data key="d9">0.0</data>',
                                    '<data key="d9">0.03</data>')
    return Scenario(
        stop_time=40 * 10**9, topology_graphml=lossy,
        hosts=[_tgen("server", SERVER_GRAPH, 1, quantity=2),
               _tgen("web", WEB_GRAPH, 2, quantity=2),
               _tgen("dead", TIMEOUT_GRAPH), _tgen("idle", FORK_GRAPH)])


def _fork():
    """tests/test_tgen.py::test_tgen_fork_and_synchronize, 40 sim-s."""
    return Scenario(
        stop_time=40 * 10**9, topology_graphml=SIMPLE_TOPOLOGY,
        hosts=[_tgen("server", SERVER_GRAPH, 1, quantity=2),
               _tgen("client", FORK_GRAPH, 2, quantity=2),
               _tgen("dead", TIMEOUT_GRAPH), _tgen("idle", WEB_GRAPH)])


def _timeout():
    """tests/test_tgen.py::test_tgen_timeout_aborts_and_walk_continues:
    the first GET's peer ("dead", whose process never starts) has no
    listener."""
    return Scenario(
        stop_time=30 * 10**9, topology_graphml=SIMPLE_TOPOLOGY,
        hosts=[_tgen("server1", SERVER_GRAPH, 1), _tgen("dead", WEB_GRAPH),
               _tgen("client", TIMEOUT_GRAPH, 2),
               _tgen("server2", FORK_GRAPH),
               _tgen("idle", SERVER_GRAPH, quantity=2)])


def test_lossy_web_matches():
    rrep, _ = run_both(_lossy_web, CFG)
    assert rrep.stats[2:4, defs.ST_XFER_DONE].sum() > 0
    assert rrep.stats[:, defs.ST_RETRANSMIT].sum() > 0


def test_fork_and_synchronize_match():
    rrep, _ = run_both(_fork, CFG)
    st = rrep.stats
    # both forked GETs of a round complete before synchronize fires
    assert (st[2:4, defs.ST_XFER_DONE] >= 2).all()
    assert (st[2:4, defs.ST_XFER_DONE] % 2 == 0).all()
    assert st[:, defs.ST_TGEN_DROP].sum() == 0


def test_timeout_abort_matches():
    rrep, _ = run_both(_timeout, CFG)
    st = rrep.stats
    assert st[2, defs.ST_TGEN_ABORT] == 1
    assert st[2, defs.ST_XFER_DONE] == 1 and st[2, defs.ST_APP_DONE] == 1


def test_direct_index_reads_match():
    """Wakes whose socket slot lies outside the table (-1, or the table
    width) reach on_connected, on_accept, on_eof and on_sent: the
    reference indexes sk_syn_tag/sk_used/sk_parent directly there (a
    slot of -1 reads the last socket), and the port gives its result on
    every row. Mixed in: in-range slots, fresh and stale generations,
    PUT and GET tags."""
    from tools import baseline_configs as TB
    from shadow_tpu_torch.net import packet as P
    psim = Simulation(TB.build_bulk_1k(50), device="cpu")
    rsim = RefSimulation(TB.build_bulk_1k(50))
    H, S = psim.hosts.sk_used.shape
    rng = np.random.RandomState(11)
    a = psim.hosts.numpy()
    a["sk_used"] = rng.rand(H, S) < 0.6
    a["sk_state"] = np.where(a["sk_used"], rng.choice([4, 7], (H, S)),
                             0).astype(np.int32)
    a["sk_proto"] = np.where(a["sk_used"], 6, 0).astype(np.int32)
    a["sk_parent"] = rng.choice([-1, 0], (H, S)).astype(np.int32)
    a["sk_syn_tag"] = (rng.randint(1, 4000, (H, S))
                       | rng.choice([0, PT.TAG_PUT], (H, S))).astype(np.int32)
    a["sk_app_ref"] = rng.choice([-1, 1, 2], (H, S)).astype(np.int32)
    a["sk_timer_gen"] = rng.randint(0, 3, (H, S)).astype(np.int32)
    a["sk_rhost"] = rng.randint(0, 10, (H, S)).astype(np.int32)
    a["sk_snd_end"] = rng.randint(0, 5000, (H, S)).astype(np.int64)
    a["app_r"][:, 0, PT.REG_T0] = 2 * 10**9
    a["txq_cnt"] = rng.randint(0, 2, H).astype(np.int32)   # NIC has work
    wake = np.zeros((H, P.PKT_WORDS), np.int32)
    wake[:, P.SEQ] = rng.choice([-1, S, 3, 5], H)
    wake[:, P.ACK] = rng.choice([3, 4, 5, 6], H)  # CONNECTED .. SENT
    wake[:, P.WND] = rng.choice([0, 1], H)        # slot generation
    now = np.full(H, 3 * 10**9, np.int64)

    def view(d):
        d = dict(d)
        d["app_node"], d["app_r"] = d["app_node"][:, 0], d["app_r"][:, 0]
        return d

    rhp = {f: np.asarray(getattr(rsim.hp, f))
           for f in rsim.hp.__dataclass_fields__}
    rhp["app_kind"] = rhp["app_kind"][:, 0]
    rhp["app_cfg"] = rhp["app_cfg"][:, 0]
    ref = jax.jit(jax.vmap(RT.app_tgen, in_axes=(0, 0, None, 0, 0)))(
        RefHosts(**{k: jnp.asarray(v) for k, v in view(a).items()}),
        RefHostParams(**{k: jnp.asarray(v) for k, v in rhp.items()}),
        rsim.sh, jnp.asarray(now), jnp.asarray(wake))
    want = {f: np.asarray(getattr(ref, f)) for f in ref.__dataclass_fields__}
    want["app_node"] = want["app_node"][:, None]
    want["app_r"] = want["app_r"][:, None]

    st = type(psim.hosts)(**{k: torch.from_numpy(v.copy())
                             for k, v in a.items()})
    PT.app_tgen(st, psim.hp, psim.sh, torch.ones(H, dtype=torch.bool),
                torch.from_numpy(now), torch.from_numpy(wake), {3, 4, 5, 6})
    got = st.numpy()
    assert (wake[:, P.SEQ] < 0).sum() > 5 and (wake[:, P.SEQ] >= S).sum() > 5
    bad = [f for f in want if not np.array_equal(got[f], want[f])]
    assert not bad, f"fields differ: {bad}"
    # the direct-index rows did something: writes kicked their NICs
    out = (wake[:, P.SEQ] < 0) | (wake[:, P.SEQ] >= S)
    assert (got["eq_time"] != a["eq_time"])[out & (wake[:, P.ACK] == 3)
                                            ].any()


def test_transfer_pick_near_one():
    """A transfer's peer pick and a drawn pause's pick,
    min(int64(u * f32(n)), n - 1), equal the reference's expression for
    uniforms next to 1 and every pool size up to 256."""
    u = np.array([np.nextafter(np.float32(1), np.float32(0)) - i * 2.0**-24
                  for i in range(8)] + [0.0, 0.5], np.float32)
    n = np.arange(1, 257, dtype=np.int64)
    uu, nn = np.meshgrid(u, n)
    ref = np.asarray(jax.jit(lambda x, c: jnp.minimum(
        (x * c.astype(jnp.float32)).astype(jnp.int64), c - 1))(uu, nn))
    got = PT._pick(torch.from_numpy(uu), torch.zeros(nn.shape,
                                                     dtype=torch.int64),
                   torch.from_numpy(nn)).numpy()
    assert np.array_equal(ref, got)
    assert (got == nn - 1).sum() > 256
