"""Parity of the port's telemetry: pcap capture, heartbeats, trace,
metrics, phase attribution, the perf ledger, the logger and the CLI's
``--test`` scenario.

tests/test_obs.py's pcap/heartbeat ping shape and a lossy TCP bulk
shape with ``logpcap`` on every host run through the JAX package and
through ``shadow_tpu_torch`` on the CPU under one engine shape (the
reference compiles once; a trace ring of 32 records overflows in the
TCP run): equal stats, windows, canonicalized ``Hosts`` fields (the
``tr_*`` ring included), byte-identical pcap files, and equal
heartbeat lines apart from the columns that measure the process
rather than the simulation (``dev=``, ``dev-peak-gib=``, ``waste=``,
and the getrusage figures). The trace, metrics, perf and ledger units
mirror tests/test_obs.py and tests/test_perf.py on the port's modules,
and the reference's tools read the port's files.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from shadow_tpu.core.config import HostSpec, ProcessSpec, Scenario
from shadow_tpu.engine import defs
from shadow_tpu.engine.sim import Simulation as RefSimulation
from shadow_tpu.engine.state import EngineConfig as RefEngineConfig
from shadow_tpu.obs import ledger as RL

from shadow_tpu_torch.__main__ import build_test_scenario
from shadow_tpu_torch.__main__ import main as port_cli
from shadow_tpu_torch.__main__ import port_fingerprint
from shadow_tpu_torch.engine.sim import Simulation
from shadow_tpu_torch.engine.state import EngineConfig
from shadow_tpu_torch.obs import ledger as LG
from shadow_tpu_torch.obs import metrics as M
from shadow_tpu_torch.obs import perf as PF
from shadow_tpu_torch.obs import trace as T
from shadow_tpu_torch.obs.logger import SimLogger

from test_tcp import poi_topology
from test_torch_parity import (ROOT, assert_states_equal,  # noqa: F401
                               one_torch_thread, ref_state)

# one engine shape for both whole runs; the dense drain compiles
# fastest in the reference, which is bit-identical under every setting
CFG = dict(qcap=16, scap=4, obcap=32, incap=32, chunk_windows=8,
           tracecap=32, active_block=0)
LATE = 1000         # a start (s) past every stop time: the process never runs


@pytest.fixture(autouse=True)
def _obs_globals_reset():
    """The trace/metrics recorders are process-global; a failed test
    must not leak one into the next."""
    yield
    T.finish()
    M.finish()


def _scen(ping, stop, topo, size=400_000):
    """tests/test_obs.py's ping pair and tests/test_obs.py's TCP bulk
    pair, every host with logpcap; the pair not under test never
    starts."""
    t_psrv, t_pcli = (1, 2) if ping else (LATE, LATE)
    t_srv, t_cli = (LATE, LATE) if ping else (1, 2)
    return Scenario(
        stop_time=stop * 10**9, topology_graphml=topo,
        hosts=[
            HostSpec(id="srv", pcap=True, processes=[ProcessSpec(
                plugin="pingserver", start_time=t_psrv * 10**9,
                arguments="port=8000")]),
            HostSpec(id="cli", pcap=True, processes=[ProcessSpec(
                plugin="ping", start_time=t_pcli * 10**9,
                arguments="peer=srv port=8000 interval=500ms size=100 "
                          "count=3")]),
            HostSpec(id="server", pcap=True, processes=[ProcessSpec(
                plugin="bulkserver", start_time=t_srv * 10**9,
                arguments="port=80")]),
            HostSpec(id="client", pcap=True, processes=[ProcessSpec(
                plugin="bulk", start_time=t_cli * 10**9,
                arguments=f"peer=server port=80 size={size} count=1 "
                          "pause=1s")]),
        ])


_MEASURED = re.compile(r",dev=\d+|dev-peak-gib=[^,]*,|waste=[^,]*,|"
                       r"maxrss-gib=.*$")


def _norm(lines):
    """Heartbeat lines minus the columns that measure the process."""
    return [_MEASURED.sub("", line) for line in lines]


def _both(tmp_path, scen, heartbeat_s):
    """One scenario through both packages with pcap capture and
    heartbeats -> (port Simulation, its report, its log text); asserts
    equal stats, windows, Hosts fields, pcap bytes and heartbeats."""
    out = {}
    for side, sim_cls, cfg_cls in (
            ("ref", RefSimulation, RefEngineConfig),
            ("port", Simulation, EngineConfig)):
        kw = {"device": "cpu"} if side == "port" else {}
        sim = sim_cls(scen(), engine_cfg=cfg_cls(num_hosts=4, **CFG), **kw)
        log = io.StringIO()
        rep = sim.run(heartbeat_s=heartbeat_s,
                      logger=SimLogger(stream=log),
                      pcap_dir=str(tmp_path / side))
        out[side] = (sim, rep, log.getvalue())
    (rsim, rrep, _), (psim, prep, plog) = out["ref"], out["port"]
    assert np.array_equal(rrep.stats, prep.stats)
    assert rrep.windows == prep.windows
    assert_states_equal(ref_state(rsim), psim.final_hosts.numpy())
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 4
    for name in names:
        assert ((tmp_path / "ref" / name).read_bytes()
                == (tmp_path / "port" / name).read_bytes()), name
    assert _norm(rrep.heartbeats) == _norm(prep.heartbeats)
    return psim, prep, plog


def _records(path):
    data = path.read_bytes()
    off, lens = 24, []
    while off < len(data):
        _ts, _tus, incl, orig = np.frombuffer(data[off:off + 16], "<u4")
        lens.append(int(orig))
        off += 16 + int(incl)
    return lens


def test_pcap_and_heartbeats_ping_match(tmp_path):
    """tests/test_obs.py's pcap and heartbeat ping shape: 3 pings and 3
    echoes per side (142-byte UDP frames), [node]/[socket]/[summary]
    lines every second."""
    _, prep, _ = _both(
        tmp_path, lambda: _scen(True, 6, poi_topology()), 1.0)
    assert _records(tmp_path / "port" / "cli-eth0.pcap") == [142] * 6
    assert _records(tmp_path / "port" / "server-eth0.pcap") == []
    hb = prep.heartbeats
    assert any("[node]" in x and ",cli," in x for x in hb)
    assert any("[socket]" in x and ",cli," in x and "udp" in x for x in hb)
    spans = [int(x.split("interval=")[1].split(",")[0])
             for x in hb if "[summary]" in x]
    assert sum(spans) >= 5


def test_pcap_and_heartbeats_lossy_tcp_match(tmp_path):
    """A 400 kB bulk push over a 3%-loss, 1 MB/s link: handshakes,
    retransmissions and SACK in the pcap bytes, a trace ring that
    overflows (equal tr_drop), [socket] and [ram] lines, and
    tools/parse_heartbeat.py reading the port's log."""
    psim, prep, plog = _both(
        tmp_path, lambda: _scen(False, 8, poi_topology(loss=0.03,
                                                       bw_up=1024)), 0.5)
    assert prep.total(defs.ST_RETRANSMIT) > 0
    assert prep.total(defs.ST_PKTS_DROP_NET) > 0
    assert int(psim.final_hosts.tr_drop.sum()) > 0
    assert len(_records(tmp_path / "port" / "client-eth0.pcap")) > 100
    hb = prep.heartbeats
    assert any("[socket]" in x and "tcp" in x for x in hb)
    ram = [x for x in hb if "[ram]" in x]
    assert ram and any(int(x.split(",")[4]) > 0 for x in ram)
    log = tmp_path / "port.log"
    log.write_text(plog)
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "parse_heartbeat.py"),
         str(log)], capture_output=True, text=True, check=True).stdout
    assert out.splitlines()[0].startswith("time,host")
    assert any(",client," in x for x in out.splitlines()[1:])


def test_trace_and_metrics_units(tmp_path):
    """tests/test_obs.py's span nesting, disabled no-op and registry
    semantics on the port's modules."""
    path = str(tmp_path / "t.json")
    T.install(path)
    with T.span("outer", kind="test"):
        with T.span("inner"):
            pass
        t0 = T.TRACER.now()
        T.TRACER.complete("hot", t0, args={"n": 3})
    T.finish()
    assert not T.ENABLED and T.TRACER is None
    doc = json.load(open(path))
    evs = {e["name"]: e for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert set(evs) == {"outer", "inner", "hot"}
    outer, inner = evs["outer"], evs["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    assert outer["args"] == {"kind": "test"} and evs["hot"]["args"] == {
        "n": 3}
    assert any(e.get("ph") == "M" for e in doc["traceEvents"])
    with T.span("never"):
        pass
    assert T.TRACER is None

    reg = M.install()
    reg.counter("a").inc()
    reg.counter("a").inc(4)
    reg.gauge("g").set(2.5)
    h = reg.histogram("h", bounds=(10, 100))
    for v in (1, 9, 10, 11, 250):
        h.observe(v)
    reg.publish("sim", {"events": 7, "device": "cuda", "flag": True})
    snap = reg.snapshot()
    M.finish()
    assert snap["counters"]["a"] == 5 and snap["gauges"]["g"] == 2.5
    hs = snap["histograms"]["h"]
    assert (hs["count"], hs["min"], hs["max"], hs["sum"]) == (5, 1, 250, 281)
    assert hs["buckets"] == {"le_10": 3, "le_100": 1, "overflow": 1}
    # publish keeps numbers only: the snapshot's BENCH-diffable section
    assert snap["sim"] == {"events": 7}


def _entry(rate=100.0, platform="cuda", fp="f0", phases=None):
    s = {"events": 1000, "wall_seconds": 1000 / rate,
         "events_per_sec": rate, "sim_seconds": 5.0, "windows": 10,
         "passes": 40, "waste_frac": 0.5}
    return LG.make_entry("phold-64", fp, platform, s, phases=phases)


def test_perf_and_ledger_units(tmp_path, monkeypatch):
    """tests/test_perf.py's ledger round trip, torn line, env switch,
    fingerprint keying and synthetic attribution on the port's
    modules; tools/perf_regress.py gates a port ledger."""
    path = str(tmp_path / "ledger.jsonl")
    assert LG.append(_entry(100.0), path) == path
    LG.append(_entry(105.0), path)
    with open(path, "a") as f:
        f.write('{"format": "shadow_tpu.perf.led')  # torn append
    got = LG.read(path)
    assert [e["events_per_sec"] for e in got] == [100.0, 105.0]
    assert got[0]["format"] == RL.FORMAT and got[0]["platform"] == "cuda"
    assert LG.key_of(got[0]) == LG.key_of(got[1])
    assert got[0]["passes_per_window"] == 4.0
    assert LG.entry_rate(got[0]) == 100.0
    a = EngineConfig(num_hosts=64, qcap=16)
    assert LG.fingerprint_of(a) != LG.fingerprint_of(
        EngineConfig(num_hosts=64, qcap=32))
    # the same config keys the same trajectory in both packages
    assert LG.fingerprint_of(a, stop=10) == RL.fingerprint_of(
        RefEngineConfig(num_hosts=64, qcap=16), stop=10)
    monkeypatch.setenv("SHADOW_TPU_LEDGER", "off")
    assert LG.default_path() is None and LG.append(_entry()) is None
    monkeypatch.setenv("SHADOW_TPU_LEDGER", str(tmp_path / "l.jsonl"))
    assert LG.append(_entry()) == str(tmp_path / "l.jsonl")
    monkeypatch.delenv("SHADOW_TPU_LEDGER")
    assert LG.default_path() == os.path.join(ROOT, "perf", "ledger.jsonl")

    def ev(name, ts_ms, dur_ms):
        return {"name": name, "ph": "X", "pid": 1, "tid": 0,
                "ts": ts_ms * 1000.0, "dur": dur_ms * 1000.0}

    att = PF.attribute([ev("chunk", 0, 500),
                        ev("tracker.heartbeat", 200, 100)], 0.5, 100)
    assert abs(att["phases"]["window"]["wall_s"] - 0.4) < 1e-9
    assert abs(att["phases"]["tracker"]["wall_s"] - 0.1) < 1e-9
    assert att["ok"] and att["phases"]["window"]["us_per_event"] == 4000.0
    low = PF.attribute([ev("chunk", 0, 100)], 1.0)
    assert not low["ok"] and low["residual_frac"] == pytest.approx(0.9)
    assert "WARNING" in PF.format_report(low)
    assert "surprise" in PF.attribute([ev("surprise", 0, 950)], 1.0)[
        "phases"]

    tool = os.path.join(ROOT, "tools", "perf_regress.py")
    good = str(tmp_path / "good.jsonl")
    for r in (100.0, 101.0, 99.0, 100.5):
        LG.append(_entry(r), good)
    assert subprocess.run([sys.executable, tool, good],
                          capture_output=True).returncode == 0
    bad = str(tmp_path / "bad.jsonl")
    for r in (100.0, 101.0, 99.0, 40.0):
        LG.append(_entry(r), bad)
    out = subprocess.run([sys.executable, tool, bad],
                         capture_output=True, text=True)
    assert out.returncode == 1, out.stdout


def test_run_trace_metrics(tmp_path):
    """tests/test_obs.py's run smoke on the port: chunk spans carry the
    sim range, windows and events and tally with the report; the
    snapshot's sim, perf and memory sections; per-chunk lines;
    tools/trace_report.py reads the timeline."""
    tr, mt = str(tmp_path / "trace.json"), str(tmp_path / "m.json")
    sim = Simulation(_scen(True, 6, poi_topology()), device="cpu",
                     engine_cfg=EngineConfig(num_hosts=4, **CFG))
    rep = sim.run(heartbeat_s=1.0, trace=tr, metrics=mt,
                  pcap_dir=str(tmp_path / "pcap"))
    assert not T.ENABLED and not M.ENABLED
    evs = [e for e in json.load(open(tr))["traceEvents"]
           if e.get("ph") == "X"]
    assert {"run.setup", "chunk", "pcap.drain", "tracker.heartbeat",
            "report.finalize"} <= {e["name"] for e in evs}
    chunks = [e for e in evs if e["name"] == "chunk"]
    assert sum(c["args"]["events"] for c in chunks) == rep.events
    assert sum(c["args"]["windows"] for c in chunks) == rep.windows
    assert sum(c["args"]["passes"] for c in chunks) == rep.passes
    assert all(c["args"]["sim_ns_end"] >= c["args"]["sim_ns_start"]
               for c in chunks)
    snap = json.load(open(mt))
    assert snap["sim"]["events"] == rep.events
    assert snap["counters"]["engine.windows"] == rep.windows
    assert snap["counters"]["tracker.lines"] == len(rep.heartbeats)
    assert snap["counters"]["pcap.records"] == 12
    assert snap["perf"]["attributed_frac"] > 0
    assert snap["memory"]["peak_bytes"] == rep.memory["peak_bytes"] > 0
    lines = [json.loads(x) for x in open(mt + ".chunks.jsonl")]
    assert len(lines) == snap["counters"]["engine.chunks"] == len(chunks)
    assert sum(x["events"] for x in lines) == rep.events
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "trace_report.py"),
         tr, "--json"], capture_output=True, text=True, check=True).stdout
    assert any(s["name"] == "chunk" for s in json.loads(out)["spans"])


def test_obs_flags_keep_digest_chain(tmp_path):
    """The port's CLI with --trace --metrics --perf LEDGER
    --heartbeat-frequency --pcap-dir records the plain run's digest
    chain; --perf attributes >= 90% of the wall and writes a `cpu`
    ledger entry that tools/perf_regress.py reads."""
    xml = os.path.join(ROOT, "examples", "ping.xml")
    plain, obs = str(tmp_path / "plain.jsonl"), str(tmp_path / "obs.jsonl")
    ledger = str(tmp_path / "ledger.jsonl")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert port_cli([xml, "--device", "cpu", "--digest", plain,
                         "--digest-every", "2"]) == 0
        assert port_cli([xml, "--device", "cpu", "--digest", obs,
                         "--digest-every", "2",
                         "--trace", str(tmp_path / "t.json"),
                         "--metrics", str(tmp_path / "m.json"),
                         "--perf", ledger, "--heartbeat-frequency", "1",
                         "--pcap-dir", str(tmp_path / "pcap")]) == 0
    assert open(plain, "rb").read() == open(obs, "rb").read()
    text = out.getvalue()
    m = re.search(r"\(([\d.]+)% of [\d.]+s wall attributed\)", text)
    assert m and float(m.group(1)) >= 90.0, text
    assert "[shadow-heartbeat] [node]" in text
    (entry,) = LG.read(ledger)
    assert entry["platform"] == "cpu" and entry["scenario"] == "ping"
    assert entry["events"] > 0 and entry["phases"]["window"] > 0
    tool = os.path.join(ROOT, "tools", "perf_regress.py")
    assert subprocess.run([sys.executable, tool, ledger],
                          capture_output=True).returncode == 0
    assert json.load(open(tmp_path / "t.json"))["traceEvents"]


# `python -m shadow_tpu --test --test-clients 20 --stop-time 4s
# --summary-json` (the JAX package on the CPU; its tgen program takes
# ~90 s to compile, so its counts are kept here)
REF_TEST_COUNTS = {"hosts": 21, "events": 3021, "windows": 25,
                   "pkts_sent": 1160, "pkts_recv": 1160, "drop_net": 0,
                   "drop_q": 0, "bytes_recv": 645120, "retransmits": 0,
                   "transfers_done": 35, "transfers_aborted": 0}


def test_port_ledger_key_differs_from_reference():
    """A port entry and a reference entry of one scenario and config
    never share a trajectory: the port's CLI adds engine="torch" to the
    reference CLI's fingerprint arguments, and its entries carry the
    engine field (no whole run: the keys alone)."""
    from shadow_tpu.__main__ import build_test_scenario as ref_build
    scen = build_test_scenario(20)
    cfg, rcfg = EngineConfig(num_hosts=21), RefEngineConfig(num_hosts=21)
    args = dict(seed=scen.seed, stop_ns=int(ref_build(20).stop_time),
                runahead="", workers=0)
    ref_fp = RL.fingerprint_of(rcfg, **args)
    assert LG.fingerprint_of(cfg, **args) == ref_fp
    port_fp = port_fingerprint(cfg, scen, None)
    assert port_fp != ref_fp
    assert port_fp == LG.fingerprint_of(cfg, engine="torch", **args)
    s = {"events": 10, "wall_seconds": 1.0, "events_per_sec": 10.0}
    port = LG.make_entry("test", port_fp, "cpu", s)
    ref = RL.make_entry("test", ref_fp, "cpu", s)
    assert port["engine"] == "torch" and "engine" not in ref
    assert LG.key_of(port) != RL.key_of(ref)


def test_cli_test_scenario():
    """--test --test-clients 20 at a 4 s stop: the builtin scenario is
    the reference's, and the summary's counts are the reference's."""
    from shadow_tpu.__main__ import build_test_scenario as ref_build
    r, p = ref_build(20), build_test_scenario(20)
    assert repr(r) == repr(p)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert port_cli(["--test", "--test-clients", "20", "--stop-time",
                         "4s", "--device", "cpu", "--summary-json"]) == 0
    s = json.loads(out.getvalue().strip().splitlines()[-1])
    assert {k: s[k] for k in REF_TEST_COUNTS} == REF_TEST_COUNTS


def test_logger_levels(capsys):
    lg = SimLogger(level="message")
    lg.message(1_500_000_000, "hostA", "hello")
    lg.debug(2_000_000_000, "hostA", "invisible")
    lg.set_host_level("chatty", "debug")
    lg.debug(2_000_000_000, "chatty", "visible")
    out = capsys.readouterr().out
    assert "hello" in out and "0:00:01.500000000" in out
    assert "[shadow-tpu]" in out and "[message] [hostA]" in out
    assert "invisible" not in out and "visible" in out
    with pytest.raises(RuntimeError, match="boom"):
        lg.error(0, "hostA", "boom")
