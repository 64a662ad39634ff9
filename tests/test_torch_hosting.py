"""Parity of the port's hosting tier (``shadow_tpu_torch/hosting/``,
``net/channel.py``) with the JAX package.

tests/test_hosting.py's shapes (a hosted UDP pinger, a hosted TCP
putter, hosted beside modeled on one host, two runs alike),
tests/test_loopback.py's (the TCP self-channel, that it stays local,
the pipe channel and a pipe write past the 64 KiB buffer) and
tests/test_cplugin.py's ``cping`` run through the reference and through
the port on the CPU: equal stats, windows, digest chains record by
record (the ``hosted`` section included), ``SimReport.hosted``, every
canonicalized Hosts field (``hw_*`` included) and what the apps saw.
Each Python app is defined once here, duck-typed, and registered with
both packages. All scenarios share one engine shape (three hosts, two
process slots, one app-kind set; hosts whose process starts after the
stop pad the smaller ones), so the reference compiles once.
"""

import ctypes
import os

import numpy as np
import pytest

from shadow_tpu import hosting as ref_hosting
from shadow_tpu.apps.base import (APP_BULK_SERVER, APP_HOSTED, APP_PING,
                                  APP_PING_SERVER)
from shadow_tpu.core.config import HostSpec, ProcessSpec, Scenario
from shadow_tpu.engine import defs
from shadow_tpu.engine.sim import Simulation as RefSimulation
from shadow_tpu.engine.state import EngineConfig as RefEngineConfig
from shadow_tpu.hosting import cplugin as ref_cplugin

from shadow_tpu_torch import hosting
from shadow_tpu_torch.engine.sim import Simulation
from shadow_tpu_torch.engine.state import EngineConfig
from shadow_tpu_torch.hosting import cplugin

from conftest import SIMPLE_TOPOLOGY
from test_torch_parity import ROOT, assert_states_equal, ref_state
from test_torch_parity import one_torch_thread  # noqa: F401

N_HOSTS = 3
CFG = dict(qcap=32, scap=8, obcap=16, incap=32, txqcap=8, procs_per_host=2,
           app_kinds=(0, APP_PING, APP_PING_SERVER, APP_BULK_SERVER,
                      APP_HOSTED))
LATE = 10**12       # a start time past every stop: the process never runs
CPING_C = os.path.join(ROOT, "examples", "plugins", "cping.c")


class App:
    """No-op callbacks: the HostedApp surface of both packages."""

    def on_start(self, os):
        pass

    def on_timer(self, os, tag):
        pass

    def on_connected(self, os, sock, lport=0, peer=(0, 0)):
        pass

    def on_accept(self, os, sock, tag, dport=0, peer=(0, 0)):
        pass

    def on_eof(self, os, sock):
        pass

    def on_sent(self, os, sock):
        pass

    def on_dgram(self, os, sock, src, sport, nbytes, aux):
        pass


class Pinger(App):
    """UDP ping client (tests/test_hosting.py's HostedPinger)."""

    def __init__(self, args):
        kv = dict(tok.split("=") for tok in args.split())
        self.peer = kv["peer"]
        self.port = int(kv.get("port", 8000))
        self.count = int(kv.get("count", 5))
        self.interval = int(float(kv.get("interval_s", 1)) * 10**9)
        self.size = int(kv.get("size", 64))
        self.sent = self.echoed = 0

    def on_start(self, os):
        self.sock = os.udp_open()
        self._send(os)

    def _send(self, os):
        os.sendto(self.sock, self.peer, self.port, self.size, aux=42)
        self.sent += 1
        if self.sent < self.count:
            os.timer(self.interval)

    def on_timer(self, os, tag):
        self._send(os)

    def on_dgram(self, os, sock, src, sport, nbytes, aux):
        assert aux == 42
        self.echoed += 1

    def seen(self):
        return self.sent, self.echoed


class Putter(App):
    """TCP PUT client against bulkserver (HostedPutter)."""

    def __init__(self, args):
        kv = dict(tok.split("=") for tok in args.split())
        self.peer = kv["peer"]
        self.port = int(kv.get("port", 80))
        self.size = int(kv.get("size", 50 * 1024))
        self.done = 0

    def on_start(self, os):
        self.sock = os.tcp_connect(self.peer, self.port)

    def on_connected(self, os, sock, **_identity):
        os.write(sock, self.size)
        os.close(sock)

    def on_sent(self, os, sock):
        self.done += 1

    def seen(self):
        return self.done


class SelfChannel(App):
    """Listens and connects to itself over loopback, then PUTs bytes
    through (tests/test_loopback.py)."""

    def __init__(self, args):
        self.size = int(args) if args.strip() else 50000
        self.done = self.got_eof = 0

    def on_start(self, os):
        self.listener = os.tcp_listen(7000)
        self.client = os.tcp_connect(os.host_id, 7000)

    def on_connected(self, os, sock, **_identity):
        os.write(sock, self.size)
        os.close(sock)

    def on_sent(self, os, sock):
        self.done += 1

    def on_eof(self, os, sock):
        self.got_eof += 1
        os.close(sock)

    def seen(self):
        return self.done, self.got_eof


class PipeApp(App):
    """Moves bytes through an os.pipe() pair."""

    def __init__(self, args):
        self.size = int(args) if args.strip() else 50000
        self.got = self.eofs = 0

    def on_start(self, os):
        self.a, self.b = os.pipe()
        os.timer(1000)          # the handles resolve before this wake

    def on_timer(self, os, tag):
        os.write(self.a, self.size)
        os.close(self.a)

    def on_dgram(self, os, sock, src, sport, nbytes, aux):
        self.got += nbytes

    def on_eof(self, os, sock):
        self.eofs += 1
        os.close(sock)

    def seen(self):
        return self.got, self.eofs


for _name, _cls in (("tt-pinger", Pinger), ("tt-putter", Putter),
                    ("tt-selfchannel", SelfChannel),
                    ("tt-pipeapp", PipeApp)):
    ref_hosting.register(_name, _cls)
    hosting.register(_name, _cls)


def _proc(plugin, start_s, args):
    return ProcessSpec(plugin=plugin, start_time=int(start_s * 10**9),
                       arguments=args)


def _pad(hosts):
    """Fill the scenario to N_HOSTS with hosts that never start."""
    return hosts + [HostSpec(id=f"pad{i}", processes=[
        ProcessSpec(plugin="pingserver", start_time=LATE,
                    arguments="port=9")])
        for i in range(N_HOSTS - len(hosts))]


def _scen(stop_s, hosts):
    return Scenario(stop_time=stop_s * 10**9,
                    topology_graphml=SIMPLE_TOPOLOGY, hosts=_pad(hosts))


def run_both(make, tmp_path, hosted_at):
    """One scenario on the reference and on the port (CPU), digest every
    8 windows -> (port report, ref app, port app) for the hosted app of
    host `hosted_at`. Asserts equal stats, windows, chains, SimReport
    .hosted, Hosts fields and what the two app instances saw."""
    ref_dg, port_dg = str(tmp_path / "ref.jsonl"), str(tmp_path / "p.jsonl")
    rsim = RefSimulation(make(), engine_cfg=RefEngineConfig(
        num_hosts=N_HOSTS, **CFG))
    rapp = rsim.hosting.apps[hosted_at]
    rrep = rsim.run(digest=ref_dg, digest_every=8)
    psim = Simulation(make(), engine_cfg=EngineConfig(num_hosts=N_HOSTS,
                                                      **CFG), device="cpu")
    papp = psim.hosting.apps[hosted_at]
    prep = psim.run(digest=port_dg, digest_every=8)
    assert psim.cfg.hostedcap == rsim.cfg.hostedcap == 32
    assert np.array_equal(rrep.stats, prep.stats), (
        np.argwhere(rrep.stats != prep.stats)[:10])
    assert (rrep.windows, rrep.sim_time_ns) == (prep.windows,
                                                prep.sim_time_ns)
    assert rrep.hosted == prep.hosted
    ref_lines = open(ref_dg, "rb").read().splitlines()
    port_lines = open(port_dg, "rb").read().splitlines()
    assert b'"hosted"' in port_lines[-1]
    assert ref_lines == port_lines
    assert_states_equal(ref_state(rsim), psim.final_hosts.numpy())
    if hasattr(papp, "seen"):
        assert rapp.seen() == papp.seen()
    return prep, rapp, papp


def test_hosted_udp_ping(tmp_path):
    rep, _, app = run_both(lambda: _scen(10, [
        HostSpec(id="srv", processes=[_proc("pingserver", 1, "port=8000")]),
        HostSpec(id="cli", processes=[_proc(
            "hosted:tt-pinger", 2, "peer=srv port=8000 count=4 "
            "interval_s=1 size=64")])]), tmp_path, 1)
    assert app.seen() == (4, 4)
    assert rep.stats[1, defs.ST_BYTES_RECV] == 4 * 64


def test_hosted_tcp_put(tmp_path):
    rep, _, app = run_both(lambda: _scen(15, [
        HostSpec(id="srv", processes=[_proc("bulkserver", 1, "port=80")]),
        HostSpec(id="cli", processes=[_proc(
            "hosted:tt-putter", 2, "peer=srv port=80 size=51200")])]),
        tmp_path, 1)
    assert app.done == 1
    assert rep.stats[0, defs.ST_XFER_DONE] == 1
    assert rep.stats[0, defs.ST_BYTES_RECV] == 51200


def _hosted_plus_modeled():
    """A hosted putter in process slot 1 beside a modeled pinger in
    slot 0 of the same host: its sockets must wake it (sk_proc through
    the op replay)."""
    return _scen(15, [
        HostSpec(id="srv", processes=[_proc("bulkserver", 1, "port=80"),
                                      _proc("pingserver", 1, "port=8000")]),
        HostSpec(id="cli", processes=[
            _proc("ping", 2, "peer=srv port=8000 count=3 interval=1s "
                  "size=64"),
            _proc("hosted:tt-putter", 3, "peer=srv port=80 size=51200")])])


def test_hosted_plus_modeled_one_host(tmp_path):
    rep, _, app = run_both(_hosted_plus_modeled, tmp_path, 1)
    assert app.done == 1
    assert rep.stats[0, defs.ST_XFER_DONE] == 1
    assert rep.stats[1, defs.ST_RTT_COUNT] == 3


def test_hosted_deterministic(tmp_path):
    """Two port runs of one scenario give the same chain and stats."""
    def go(name):
        path = str(tmp_path / f"{name}.jsonl")
        sim = Simulation(_hosted_plus_modeled(), engine_cfg=EngineConfig(
            num_hosts=N_HOSTS, **CFG), device="cpu")
        assert sim.hosting.procs[1] == 1
        rep = sim.run(digest=path, digest_every=8)
        return rep.stats, open(path, "rb").read()

    (s1, c1), (s2, c2) = go("a"), go("b")
    assert np.array_equal(s1, s2) and c1 == c2


def _solo(plugin, arg, stop_s=10, bystander=False):
    hosts = [HostSpec(id="solo", processes=[_proc(plugin, 1, str(arg))])]
    if bystander:
        hosts.append(HostSpec(id="bystander"))
    return _scen(stop_s, hosts)


def test_loopback_tcp_channel(tmp_path):
    rep, _, app = run_both(lambda: _solo("hosted:tt-selfchannel", 50000),
                           tmp_path, 0)
    # both directions see EOF: the child reads the writer's FIN, and
    # the writer's socket sees the child's closing FIN
    assert app.seen() == (1, 2)
    assert rep.stats[0, defs.ST_BYTES_RECV] == 50000
    assert rep.stats[0, defs.ST_PKTS_DROP_NET] == 0


def test_loopback_stays_local(tmp_path):
    rep, _, _ = run_both(lambda: _solo("hosted:tt-selfchannel", 20000,
                                       bystander=True), tmp_path, 0)
    assert rep.stats[0, defs.ST_BYTES_RECV] == 20000
    assert rep.stats[1:].sum() == 0


def test_pipe_channel(tmp_path):
    rep, _, app = run_both(lambda: _solo("hosted:tt-pipeapp", 50000),
                           tmp_path, 0)
    assert app.seen() == (50000, 1)
    assert rep.stats[0, defs.ST_BYTES_RECV] == 50000


def test_pipe_large_write_not_truncated(tmp_path):
    """A write past the reference's 64 KiB channel buffer moves its
    whole byte count, in a few events where loopback TCP takes dozens."""
    rep, _, app = run_both(lambda: _solo("hosted:tt-pipeapp", 200_000),
                           tmp_path, 0)
    assert app.seen() == (200_000, 1)
    assert rep.stats[0, defs.ST_BYTES_RECV] == 200_000
    assert rep.stats[0, defs.ST_EVENTS] < 10


def test_c_plugin_pings(tmp_path):
    """examples/plugins/cping.c through both packages' ctypes loaders;
    the port builds it into its own build directory."""
    ref_cplugin.build_plugin(CPING_C)
    ref_cplugin.register_c_plugin("tt-cping", CPING_C)
    so = cplugin.build_plugin(CPING_C)
    assert os.path.dirname(so) == hosting.build.build_dir()
    cplugin.register_c_plugin("tt-cping", CPING_C)
    rep, rapp, papp = run_both(lambda: _scen(8, [
        HostSpec(id="server", processes=[_proc("pingserver", 1,
                                               "port=8000")]),
        HostSpec(id="cli", processes=[_proc(
            "hosted:tt-cping", 2, "peer=server port=8000 count=4 "
            "interval_ms=800 size=100")])]), tmp_path, 1)
    for app in (rapp, papp):
        for fn in ("plugin_get_sent", "plugin_get_echoed"):
            getattr(app.lib, fn).restype = ctypes.c_int
            getattr(app.lib, fn).argtypes = [ctypes.c_void_p]
        assert (app.lib.plugin_get_sent(app.state),
                app.lib.plugin_get_echoed(app.state)) == (4, 4)
    assert rep.stats[0, defs.ST_BYTES_RECV] == 400
