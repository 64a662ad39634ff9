"""Parity of the port's LD_PRELOAD shim (``shadow_tpu_torch/hosting/
shim.py`` and ``shim_preload.c``) with the JAX package.

Unmodified binaries built from examples/plugins (plain libc, no
simulator headers) run behind each package's own shim, as
tests/test_shim.py and tests/test_shim_libc.py run them: epclient
against a modeled bulkserver, epserver and epclient both behind the
shim, the shim beside a modeled process on one host, uping against a
modeled pingserver, pollclient, and libcprobe's clocks, sleeps, entropy
and refused pthread_create. Each runs through the reference and through
the port on the CPU: equal stats, windows, digest chains (the
``hosted`` section, with each child's protocol-stream hash, included),
``SimReport.hosted``, canonicalized Hosts fields and the bytes of every
child's output file. All scenarios share one engine shape, so the
reference compiles once. The last test holds the port's two shim
sources to the wire protocol with the reference's own conformance
checker (``shadow_tpu/lint/shimproto.py``, loaded without importing
``shadow_tpu``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from shadow_tpu.apps.base import (APP_BULK_SERVER, APP_HOSTED, APP_PING,
                                  APP_PING_SERVER)
from shadow_tpu.core.config import HostSpec, ProcessSpec, Scenario
from shadow_tpu.engine import defs
from shadow_tpu.engine.sim import Simulation as RefSimulation
from shadow_tpu.engine.state import EngineConfig as RefEngineConfig

from shadow_tpu_torch.engine.sim import Simulation
from shadow_tpu_torch.engine.state import EngineConfig

from conftest import SIMPLE_TOPOLOGY
from test_torch_parity import ROOT, assert_states_equal, ref_state
from test_torch_parity import one_torch_thread  # noqa: F401

PLUGINS = os.path.join(ROOT, "examples", "plugins")
N_HOSTS = 2
CFG = dict(qcap=32, scap=8, obcap=16, incap=32, txqcap=16, hostedcap=16,
           chunk_windows=8, procs_per_host=2,
           app_kinds=(0, APP_PING, APP_PING_SERVER, APP_BULK_SERVER,
                      APP_HOSTED))
TRANSFERS, NBYTES = 3, 100_000


@pytest.fixture(scope="module")
def bins(tmp_path_factory):
    """The example binaries, built once with cc."""
    d = tmp_path_factory.mktemp("bins")
    out = {}
    for name in ("epclient", "epserver", "uping", "pollclient",
                 "libcprobe"):
        out[name] = str(d / name)
        subprocess.run(["cc", "-O2", "-o", out[name],
                        os.path.join(PLUGINS, name + ".c"), "-lpthread"],
                       check=True)
    return out


def shim(out, argv, start_s=2):
    return ProcessSpec(plugin="hosted:shim", start_time=start_s * 10**9,
                       arguments=f"out={out} cmd={argv}")


def modeled(plugin, args, start_s=1):
    return ProcessSpec(plugin=plugin, start_time=start_s * 10**9,
                       arguments=args)


def run_both(make, tmp_path, seed=None):
    """make(tag) -> Scenario whose shim children write `<tag>.*.out`
    files. One run on the reference and one on the port (CPU), digest
    every 8 windows -> (port report, {output name: text}). Asserts
    equal stats, windows, chains, SimReport.hosted, Hosts fields and
    output bytes."""
    reps, outs = {}, {}
    for tag, sim_cls, cfg_cls, kw in (
            ("ref", RefSimulation, RefEngineConfig, {}),
            ("port", Simulation, EngineConfig, {"device": "cpu"})):
        sim = sim_cls(make(str(tmp_path / tag)), seed=seed,
                      engine_cfg=cfg_cls(num_hosts=N_HOSTS, **CFG), **kw)
        dg = str(tmp_path / f"{tag}.jsonl")
        reps[tag] = (sim, sim.run(digest=dg, digest_every=8),
                     open(dg, "rb").read().splitlines())
        outs[tag] = {f[len(tag) + 1:]: open(tmp_path / f, "rb").read()
                     for f in sorted(os.listdir(tmp_path))
                     if f.startswith(tag + ".") and f.endswith(".out")}
    (rsim, rrep, rchain), (psim, prep, pchain) = reps["ref"], reps["port"]
    assert np.array_equal(rrep.stats, prep.stats), (
        np.argwhere(rrep.stats != prep.stats)[:10])
    assert (rrep.windows, rrep.sim_time_ns) == (prep.windows,
                                                prep.sim_time_ns)
    assert rrep.hosted == prep.hosted and prep.hosted
    assert b'"shim"' in pchain[-1]
    assert rchain == pchain
    assert_states_equal(ref_state(rsim), psim.final_hosts.numpy())
    assert outs["ref"] == outs["port"] and outs["port"]
    return prep, {k: v.decode() for k, v in outs["port"].items()}


def _done(n=TRANSFERS, b=NBYTES):
    return f"transfers={n} bytes={n * b}"


def _client_scen(tag, client_bin, stop_s=60):
    return Scenario(stop_time=stop_s * 10**9,
                    topology_graphml=SIMPLE_TOPOLOGY, hosts=[
        HostSpec(id="server", processes=[modeled("bulkserver",
                                                 "port=8080")]),
        HostSpec(id="client", processes=[shim(
            f"{tag}.client.out",
            f"{client_bin} server 8080 {NBYTES} {TRANSFERS}")])])


def test_epclient_against_modeled_server(bins, tmp_path):
    rep, out = run_both(lambda t: _client_scen(t, bins["epclient"]),
                        tmp_path)
    assert _done() in out["client.out"]
    assert rep.stats[0, defs.ST_XFER_DONE] == TRANSFERS
    assert rep.stats[0, defs.ST_BYTES_RECV] == NBYTES * TRANSFERS
    # the clock the binary read is simulated time
    assert float(out["client.out"].split("secs=")[1].split()[0]) > 0.05


def test_server_and_client_binaries(bins, tmp_path):
    """Both ends real binaries, each behind its own shim."""
    rep, out = run_both(lambda t: Scenario(
        stop_time=120 * 10**9, topology_graphml=SIMPLE_TOPOLOGY, hosts=[
            HostSpec(id="server", processes=[shim(
                f"{t}.server.out", f"{bins['epserver']} 8080 {TRANSFERS}",
                start_s=1)]),
            HostSpec(id="client", processes=[shim(
                f"{t}.client.out", f"{bins['epclient']} server 8080 "
                f"{NBYTES} {TRANSFERS}")])]), tmp_path)
    assert _done() in out["server.out"] and _done() in out["client.out"]
    assert rep.stats[0, defs.ST_BYTES_RECV] == NBYTES * TRANSFERS
    assert all(v["clean"] for v in rep.hosted.values())


def test_shim_binary_plus_modeled_process(bins, tmp_path):
    """The shim child in process slot 1 beside a modeled pinger."""
    rep, out = run_both(lambda t: Scenario(
        stop_time=60 * 10**9, topology_graphml=SIMPLE_TOPOLOGY, hosts=[
            HostSpec(id="server", processes=[
                modeled("bulkserver", "port=8080"),
                modeled("pingserver", "port=8000")]),
            HostSpec(id="client", processes=[
                modeled("ping", "peer=server port=8000 count=3 "
                        "interval=1s size=64", start_s=2),
                shim(f"{t}.client.out", f"{bins['epclient']} server 8080 "
                     f"{NBYTES} {TRANSFERS}", start_s=3)])]), tmp_path)
    assert _done() in out["client.out"]
    assert rep.stats[0, defs.ST_XFER_DONE] == TRANSFERS
    assert rep.stats[1, defs.ST_RTT_COUNT] == 3


def test_udp_binary_against_modeled_server(bins, tmp_path):
    count, size = 5, 256
    rep, out = run_both(lambda t: Scenario(
        stop_time=60 * 10**9, topology_graphml=SIMPLE_TOPOLOGY, hosts=[
            HostSpec(id="server", processes=[modeled("pingserver",
                                                     "port=8000")]),
            HostSpec(id="client", processes=[shim(
                f"{t}.client.out",
                f"{bins['uping']} server 8000 {size} {count}")])]),
        tmp_path)
    assert f"echoes={count} bytes={size * count}" in out["client.out"]
    assert rep.stats[1, defs.ST_PKTS_RECV] == count


def test_poll_select_client(bins, tmp_path):
    rep, out = run_both(lambda t: _client_scen(t, bins["pollclient"]),
                        tmp_path)
    assert _done() in out["client.out"]
    assert f"ports_ok={TRANSFERS}" in out["client.out"]
    assert rep.stats[0, defs.ST_BYTES_RECV] == NBYTES * TRANSFERS


@pytest.fixture(scope="module")
def probe(bins, tmp_path_factory):
    """libcprobe (a 900 ms sleep, 16 entropy bytes) behind the shim in
    both packages -> its output parsed as {"line.key": value}."""
    tmp = tmp_path_factory.mktemp("probe")
    _, out = run_both(lambda t: Scenario(
        stop_time=30 * 10**9, topology_graphml=SIMPLE_TOPOLOGY, hosts=[
            HostSpec(id="probe", processes=[shim(
                f"{t}.probe.out", f"{bins['libcprobe']} 900 16",
                start_s=1)]),
            HostSpec(id="pad", processes=[modeled(
                "pingserver", "port=9", start_s=1000)])]), tmp, seed=7)
    d = {}
    for line in out["probe.out"].splitlines():
        parts = line.split()
        for p in parts[1:]:
            k, _, v = p.partition("=")
            d[parts[0] + "." + k] = v
    return d


def test_libc_clocks_sleep_and_entropy(probe):
    """Sleeps advance simulated time, every clock reads it, entropy
    comes from the host's seeded PRNG (equal bytes in both packages)
    and writing an entropy fd fails with EBADF."""
    assert 0.85 <= float(probe["slept.measured"]) <= 1.1, probe
    mono, real, tod = (float(probe["clocks.mono"]),
                       float(probe["clocks.real"]),
                       float(probe["clocks.tod"]))
    assert abs(mono - real) < 0.05 and abs(real - tod) < 0.05
    assert 0.9 <= mono <= 1.5
    assert probe["entropy.getrandom"] != "00" * 16
    assert probe["entropy.getrandom"] != probe["entropy.urandom"]
    assert probe["fentropy.fopen"] != "00" * 16
    assert (int(probe["urandomwrite.rc"]),
            int(probe["urandomwrite.errno"])) == (-1, 9)
    assert 0.25 <= float(probe["pollsleep.measured"]) <= 0.45


def test_pthread_create_refused(probe):
    """pthread_create fails loudly (EAGAIN) under the shim."""
    assert int(probe["threads.pthread_create"]) == 11


_CONFORMANCE = """
import importlib.util, os, sys
root, here = sys.argv[1], sys.argv[2]
lint = os.path.join(root, "shadow_tpu", "lint")
spec = importlib.util.spec_from_file_location(
    "shadow_tpu.lint", os.path.join(lint, "__init__.py"),
    submodule_search_locations=[lint])
mod = importlib.util.module_from_spec(spec)
sys.modules["shadow_tpu.lint"] = mod
spec.loader.exec_module(mod)
from shadow_tpu.lint import shimproto
c_path = os.path.join(here, "shim_preload.c")
py_path = os.path.join(here, "shim.py")
out = shimproto.check_texts(open(c_path).read(), open(py_path).read(),
                            c_path=c_path, py_path=py_path)
assert "jax" not in sys.modules and "shadow_tpu" not in sys.modules
print(len(out))
for v in out:
    print(v)
"""


def test_shim_protocol_conformance():
    """The port's shim_preload.c and shim.py agree on the wire protocol
    (opcodes, struct layouts, payload framing), by the reference's
    checker loaded by path as tools/simlint loads it (in a process that
    imports neither jax nor the shadow_tpu package)."""
    here = os.path.join(ROOT, "shadow_tpu_torch", "hosting")
    r = subprocess.run([sys.executable, "-c", _CONFORMANCE, ROOT, here],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split("\n")[0] == "0", r.stdout
