"""Parity of the port's multi-process hosts (the reference's per-host
process list): each process slot has its own app kind, config and
registers, sockets remember their owning process, and a wake runs the
app of the process it belongs to.

tests/test_multiproc.py's shapes run through the JAX package and
through ``shadow_tpu_torch`` on the CPU: equal stats, window count and
every canonicalized ``Hosts`` field (test_torch_parity.run_both), under
one EngineConfig shape: the app kinds of every shape are named in it,
so the reference compiles once for the file (a kind no host runs only
adds a dead branch to its switch). A single-process run issues exactly
the operations it issued before multi-process routing existed.
"""

from shadow_tpu.apps.base import (APP_BULK, APP_BULK_SERVER, APP_NULL,
                                  APP_PING, APP_PING_SERVER, APP_TGEN)
from shadow_tpu.core.config import HostSpec, ProcessSpec, Scenario
from shadow_tpu.engine import defs

from test_multiproc import _mutual_scen
from test_multiproc import CFG as MP_CFG
from test_tcp import poi_topology
from test_torch_parity import one_torch_thread, run_both  # noqa: F401

CFG = dict(MP_CFG, app_kinds=(APP_NULL, APP_PING, APP_PING_SERVER, APP_TGEN,
                              APP_BULK, APP_BULK_SERVER))


def test_two_processes_mutual_transfer_matches():
    """Both hosts run a bulkserver and a bulk client of the other,
    lossless and over a 3%-loss link."""
    rrep, prep = run_both(_mutual_scen, CFG)
    assert prep.stats[0, defs.ST_BYTES_RECV] == 50000
    assert prep.stats[1, defs.ST_BYTES_RECV] == 160000
    rrep, prep = run_both(lambda: _mutual_scen(loss=0.03, stop=40), CFG)
    assert prep.stats[:, defs.ST_RETRANSMIT].sum() > 0


def _mixed():
    """A UDP ping server beside a TCP bulk client, and the mirror."""
    return Scenario(
        stop_time=30 * 10**9, topology_graphml=poi_topology(),
        hosts=[
            HostSpec(id="alpha", processes=[
                ProcessSpec(plugin="pingserver", start_time=10**9,
                            arguments="port=8000"),
                ProcessSpec(plugin="bulk", start_time=2 * 10**9,
                            arguments="peer=beta port=80 size=60000 "
                                      "count=1 pause=1s")]),
            HostSpec(id="beta", processes=[
                ProcessSpec(plugin="bulkserver", start_time=10**9,
                            arguments="port=80"),
                ProcessSpec(plugin="ping", start_time=2 * 10**9,
                            arguments="peer=alpha port=8000 "
                                      "interval=500ms size=96 count=8")]),
        ])


def test_mixed_kinds_per_host_match():
    _, prep = run_both(_mixed, CFG)
    assert prep.stats[1, defs.ST_BYTES_RECV] == 60000 + 8 * 96
    assert prep.stats[1, defs.ST_RTT_COUNT] == 8


def _tgen_server_plus_bulk():
    """A tgen server graph and a bulk client in one host's list."""
    from test_tgen import SERVER_GRAPH
    return Scenario(
        stop_time=40 * 10**9, topology_graphml=poi_topology(),
        hosts=[
            HostSpec(id="combo", processes=[
                ProcessSpec(plugin="tgen", start_time=10**9,
                            arguments=SERVER_GRAPH),
                ProcessSpec(plugin="bulk", start_time=2 * 10**9,
                            arguments="peer=peer port=80 size=40000 "
                                      "count=1 pause=1s")]),
            HostSpec(id="peer", processes=[
                ProcessSpec(plugin="bulkserver", start_time=10**9,
                            arguments="port=80")]),
        ])


def test_tgen_server_plus_bulk_client_matches():
    _, prep = run_both(_tgen_server_plus_bulk, CFG)
    assert prep.stats[1, defs.ST_BYTES_RECV] == 40000
    assert prep.stats[0, defs.ST_APP_DONE] == 1


# aten operations of the run below with one process per host: the
# routing adds none (103,886 before the chunk's control flow moved onto
# core.flow, whose eager flow runs the pass-flag and advance kernels'
# plain versions and counts passes and windows on device scalars)
SINGLE_PROCESS_OPS = 107_203


def test_single_process_pass_adds_no_operation(monkeypatch):
    """With one process per host, a run issues exactly the operations it
    issued before (counted per aten call under a dispatch mode on the
    CPU) and never computes a wake's process."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from shadow_tpu_torch.apps import base
    from shadow_tpu_torch.engine import window
    from shadow_tpu_torch.engine.sim import Simulation
    from shadow_tpu_torch.engine.state import EngineConfig
    from test_differential import CFG as BULK_CFG
    from test_differential import _bulk_scen

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    def no_routing(*a):
        raise AssertionError("a single-process pass computed a process")

    monkeypatch.setattr(window, "process_of", no_routing)
    monkeypatch.setattr(base, "process_of", no_routing)
    scen = _bulk_scen(loss=0.0, size=30_000, count=1, stop=6)
    sim = Simulation(scen(), device="cpu",
                     engine_cfg=EngineConfig(num_hosts=2, **BULK_CFG))
    assert sim.cfg.procs_per_host == 1
    with Count():
        rep = sim.run()
    assert (rep.passes, rep.events) == (75, 130)
    assert Count.n == SINGLE_PROCESS_OPS
