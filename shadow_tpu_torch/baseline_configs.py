"""Builders for the socks10k and tgen-1k configurations on the
PyTorch port.

A jax-free copy of the reference's ``tools/baseline_configs.py``
builders (``build_socks``, ``socks_caps``, ``build_bulk_1k`` with its
graphs, ``apply_runahead``, ``_plab_or_fallback``) and of
``tools/gen_topology.py:er_topology``, built on this package's
``Scenario`` and ``EngineConfig``; the tests hold them equal to the
originals.

socks10k (``bench.py:bench_socks``): ``build_socks(10_000, hops=1,
count=0, pause="5s")`` — 1,000 bulkservers, 1,000 socksproxies and
8,000 socksclients fetching 48 KiB through a 1-hop circuit — with
``socks_caps(10_000, scap=96)`` and a 10 ms runahead (:func:`socks10k`).

tgen-1k (``bench.py:bench_tgen_tcp``): ``build_bulk_1k(1000)`` — 200
tgen servers, 600 web clients (100 KiB GETs, pauses drawn from 1-5 s)
and 200 bulk clients (1 MiB PUTs, 1 s pauses), peers drawn from every
server — with ``socks_caps(1000, scap=32)`` and a 10 ms runahead
(:func:`bulk1k`).
"""

from __future__ import annotations

import os
import random

HERE = os.path.dirname(os.path.abspath(__file__))
# The PlanetLab GraphML the configuration names; when the repository
# does not carry it, a generated Erdos-Renyi graph stands in.
PLAB = os.path.join(os.path.dirname(HERE), "resource",
                    "topology.plab.graphml.xml.xz")

_HEADER = """<?xml version="1.0" encoding="utf-8"?>
<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="packetloss" attr.type="double" for="edge" id="d9" />
  <key attr.name="latency" attr.type="double" for="edge" id="d7" />
  <key attr.name="type" attr.type="string" for="node" id="d5" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="d4" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="d3" />
  <key attr.name="packetloss" attr.type="double" for="node" id="d0" />
  <graph edgedefault="undirected">"""


def _node(i, bw, loss=0.0, typ="net"):
    return (f'    <node id="poi-{i}"><data key="d0">{loss}</data>'
            f'<data key="d3">{bw}</data><data key="d4">{bw}</data>'
            f'<data key="d5">{typ}</data></node>')


def _edge(a, b, lat, loss=0.0):
    return (f'    <edge source="poi-{a}" target="poi-{b}">'
            f'<data key="d7">{lat}</data>'
            f'<data key="d9">{loss}</data></edge>')


def er_topology(n=64, p=0.1, seed=1, bw=102400, loss=0.0,
                latency=25.0, latency_range=(5.0, 80.0)):
    """Connected Erdos-Renyi GraphML: a random spanning tree plus
    G(n, p) edges, 1 ms self-loops. `latency_range=None` gives every
    edge `latency` without drawing; a range draws one uniform per
    edge."""
    rng = random.Random(seed)

    def lat():
        if latency_range is None:
            return latency
        return round(rng.uniform(*latency_range), 2)

    lines = [_HEADER]
    for i in range(n):
        lines.append(_node(i, bw))
    for i in range(n):
        lines.append(_edge(i, i, 1.0, 0.0))
    for i in range(1, n):
        lines.append(_edge(rng.randrange(i), i, lat(), loss))
    for a in range(n):
        for b in range(a + 1, n):
            if rng.random() < p:
                lines.append(_edge(a, b, lat(), loss))
    lines.append("  </graph>\n</graphml>")
    return "\n".join(lines)


def _plab_or_fallback():
    """The PlanetLab GraphML if the repository carries it, else the
    ER-300 stand-in (n=300, p=0.5, seed 7)."""
    if os.path.exists(PLAB):
        import lzma
        with lzma.open(PLAB, "rt") as f:
            return f.read()
    return er_topology(n=300, p=0.5, seed=7)


def build_socks(n_hosts, hops=1, stop=60, size=49152, count=0, pause="5s",
                relay_frac=0.10, server_frac=0.10):
    """socks10k (hops=3: the Tor shape) at `n_hosts` hosts. Host ids
    are declaration-ordered: servers, relays, clients — the ranges the
    socks app arguments name."""
    from .core.config import HostSpec, ProcessSpec, Scenario

    n_srv = max(int(n_hosts * server_frac), 1)
    n_rel = max(int(n_hosts * relay_frac), 1)
    n_cli = n_hosts - n_srv - n_rel
    rel_lo, rel_hi = n_srv, n_srv + n_rel
    return Scenario(
        stop_time=stop * 10**9,
        topology_graphml=_plab_or_fallback(),
        hosts=[
            HostSpec(id="server", quantity=n_srv, processes=[
                ProcessSpec(plugin="bulkserver", start_time=10**9,
                            arguments="port=80")]),
            HostSpec(id="relay", quantity=n_rel, processes=[
                ProcessSpec(plugin="socksproxy", start_time=10**9,
                            arguments=f"port=9050 server-port=80 "
                                      f"relay-lo={rel_lo} "
                                      f"relay-hi={rel_hi}")]),
            HostSpec(id="client", quantity=n_cli, processes=[
                ProcessSpec(plugin="socksclient", start_time=2 * 10**9,
                            arguments=f"proxy-lo={rel_lo} "
                                      f"proxy-hi={rel_hi} proxy-port=9050 "
                                      f"server-lo=0 server-hi={n_srv} "
                                      f"size={size} hops={hops} "
                                      f"count={count} pause={pause}")]),
        ],
    )


def socks_caps(n_hosts, scap=96, active_block=-1):
    """Lean caps for the SOCKS configs: qcap exceeds scap by the
    arrival headroom (every live socket keeps one standing RTO-timer
    event), incap 96, obcap 24, txqcap 16, 64 windows per chunk."""
    from .engine.state import EngineConfig
    return EngineConfig(num_hosts=n_hosts, qcap=scap + 96, scap=scap,
                        obcap=24, incap=96, txqcap=16, chunk_windows=64,
                        active_block=active_block)


_TGEN_KEYS = (
    '<key attr.name="count" attr.type="string" for="node" id="d6"/>'
    '<key attr.name="size" attr.type="string" for="node" id="d5"/>'
    '<key attr.name="type" attr.type="string" for="node" id="d4"/>'
    '<key attr.name="time" attr.type="string" for="node" id="d2"/>'
    '<key attr.name="peers" attr.type="string" for="node" id="d0"/>'
    '<key attr.name="serverport" attr.type="string" for="node" id="d1"/>')


def _tgen_client_graph(peers, ttype, size, pause, count):
    """A web/bulk-style walk: transfer -> end(count) -> pause -> start,
    peers drawn uniformly from the whole server pool."""
    return (
        '<graphml xmlns="http://graphml.graphdrawing.org/xmlns">'
        f'{_TGEN_KEYS}<graph edgedefault="directed">'
        f'<node id="start"><data key="d0">{peers}</data></node>'
        f'<node id="pause"><data key="d2">{pause}</data></node>'
        '<node id="transfer">'
        f'<data key="d4">{ttype}</data><data key="d5">{size}</data></node>'
        f'<node id="end"><data key="d6">{count}</data></node>'
        '<edge source="start" target="transfer"/>'
        '<edge source="transfer" target="end"/>'
        '<edge source="end" target="pause"/>'
        '<edge source="pause" target="start"/>'
        '</graph></graphml>')


def build_bulk_1k(n_hosts=1000, stop=60):
    """tgen-1k at `n_hosts` hosts: a fifth tgen servers, a fifth bulk
    clients, the rest web clients (the reference's example workload,
    tgen servers with web and bulk clients, scaled up). Host ids are
    declaration-ordered: servers, web, bulk."""
    from .core.config import HostSpec, ProcessSpec, Scenario

    n_srv = max(n_hosts // 5, 1)
    n_bulk = max(n_hosts // 5, 1)
    n_web = n_hosts - n_srv - n_bulk
    peers = ",".join(f"server{i + 1}:30080" for i in range(n_srv))
    server_graph = (
        '<graphml xmlns="http://graphml.graphdrawing.org/xmlns">'
        f'{_TGEN_KEYS}<graph edgedefault="directed">'
        '<node id="start"><data key="d1">30080</data></node>'
        '</graph></graphml>')
    web_graph = _tgen_client_graph(peers, "get", "100 KiB",
                                   "1,2,3,4,5", 0)
    bulk_graph = _tgen_client_graph(peers, "put", "1 MiB", "1", 0)
    return Scenario(
        stop_time=stop * 10**9,
        topology_graphml=_plab_or_fallback(),
        hosts=[
            HostSpec(id="server", quantity=n_srv, processes=[
                ProcessSpec(plugin="tgen", start_time=10**9,
                            arguments=server_graph)]),
            HostSpec(id="web", quantity=n_web, processes=[
                ProcessSpec(plugin="tgen", start_time=2 * 10**9,
                            arguments=web_graph)]),
            HostSpec(id="bulk", quantity=n_bulk, processes=[
                ProcessSpec(plugin="tgen", start_time=2 * 10**9,
                            arguments=bulk_graph)]),
        ],
    )


def apply_runahead(sim, runahead_ms):
    """Override the lookahead window (the reference's --runahead)."""
    if runahead_ms:
        sim.sh.min_jump = sim.sh.min_jump.new_tensor(runahead_ms * 10**6)
    return sim


def socks10k(n=10_000, stop=10, device=None, runahead_ms=10):
    """-> the socks10k Simulation (not yet run)."""
    from .engine.sim import Simulation
    scen = build_socks(n, hops=1, stop=stop, count=0, pause="5s")
    return apply_runahead(Simulation(scen, engine_cfg=socks_caps(n, 96),
                                     device=device), runahead_ms)


def bulk1k(n=1000, stop=10, device=None, runahead_ms=10):
    """-> the tgen-1k Simulation (not yet run)."""
    from .engine.sim import Simulation
    return apply_runahead(
        Simulation(build_bulk_1k(n, stop=stop),
                   engine_cfg=socks_caps(n, scap=32), device=device),
        runahead_ms)
