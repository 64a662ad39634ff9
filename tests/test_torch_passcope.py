"""The port's pass-time observatory and memory census against the JAX
package's: ``obs.passcope`` (occupancy, the pass table, its keys) and
``obs.memscope``'s census. Exact comparisons, zero tolerance.

One whole run shape (16-host phold on the reference's phold topology,
port only: attribution is a property of the port's own trace). The
reference is called only for its pure functions and its census of a
config, which compile no window program.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from shadow_tpu.engine.state import EngineConfig as RefEngineConfig
from shadow_tpu.obs import memscope as RMS
from shadow_tpu.obs import passcope as RPC

from shadow_tpu_torch.core.config import HostSpec, ProcessSpec, Scenario
from shadow_tpu_torch.engine.sim import Simulation
from shadow_tpu_torch.engine.state import EngineConfig
from shadow_tpu_torch.obs import ledger as LG
from shadow_tpu_torch.obs import memscope as MS
from shadow_tpu_torch.obs import passcope as PC

from test_phold import MESH_TOPO
from test_torch_parity import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

SMALL = dict(qcap=8, scap=4, obcap=8, incap=8, txqcap=4)
PHOLD_CFG = dict(qcap=16, scap=4, obcap=8, incap=16, txqcap=8,
                 chunk_windows=16)


def phold16(stop=4):
    return Scenario(
        stop_time=stop * 10**9, topology_graphml=MESH_TOPO,
        hosts=[HostSpec(id="node", quantity=16, processes=[
            ProcessSpec(plugin="phold", start_time=10**9,
                        arguments="port=9000 mean=200ms size=64 "
                                  "init=2")])])


class Gauges:
    """A metrics registry stand-in that records gauge names/values."""

    def __init__(self):
        self.vals = {}

    def gauge(self, name):
        reg = self

        class G:
            def set(self, v):
                reg.vals[name] = v
        return G()


def test_occupancy_equals_reference():
    """The reference's lane arithmetic on its own rung mixes and on the
    port's dense mix, clamp at 1 included."""
    mixes = [
        ({"k32": (32, 10), "dense": (64, 2)}, 200, 4),
        ({"w512": (512, 3), "k8": (8, 40), "dense": (1024, 1)}, 900, 16),
        ({"dense": (16, 516)}, 2426, 1),
        ({"dense": (4096, 721)}, 128_574, 1),
        ({"dense": (2, 10)}, 25, 1),            # chained NIC-TX: > 1
        ({"dense": (8, 0)}, 0, 1),
    ]
    for mix, ev, batch in mixes:
        assert PC.occupancy(mix, ev, batch) == RPC.occupancy(mix, ev,
                                                               batch)


def test_passcope_run_attributes_and_changes_nothing(tmp_path,
                                                     monkeypatch):
    """A 16-host phold run with passcope: >= 90% of the op time lands
    on pass labels, the stats, windows and digest chain equal the plain
    run's, the occupancy agrees with SimReport.waste_frac (rounded, and
    clamped at utilization 1), and the summary and the ledger entry
    carry state_bytes_per_host."""
    monkeypatch.setenv("SHADOW_TPU_PASSCOPE_CHUNKS", "2")
    cfg = EngineConfig(num_hosts=16, **PHOLD_CFG)
    plain = Simulation(phold16(), engine_cfg=cfg, device="cpu").run(
        digest=str(tmp_path / "a.jsonl"), digest_every=8)
    sim = Simulation(phold16(), engine_cfg=cfg, device="cpu")
    rep = sim.run(digest=str(tmp_path / "b.jsonl"), digest_every=8,
                  passcope=str(tmp_path / "pc"))
    assert not PC.ACTIVE
    assert (rep.stats == plain.stats).all()
    assert (rep.windows, rep.passes) == (plain.windows, plain.passes)
    assert ((tmp_path / "a.jsonl").read_bytes()
            == (tmp_path / "b.jsonl").read_bytes())

    dev = rep.device_phases
    assert dev["available"] and dev["ok"], dev
    assert dev["attributed_frac"] >= PC.MIN_ATTRIBUTED
    assert dev["chunks_traced"] == 2 and dev["device"] == "cpu"
    assert {"drain", "exchange", "advance", "cap_peaks", "nic.tx",
            "udp.deliver"} <= set(dev["phases"]) <= set(PC.PASS_LABELS)
    saved = json.loads((tmp_path / "pc" / "passcope.json").read_text())
    assert saved["device_phases"]["phases"] == dev["phases"]

    occ = rep.occupancy
    assert occ == RPC.occupancy({"dense": (16, rep.passes)}, rep.events, 1)
    util = min(1.0, rep.events / (16 * rep.passes))
    assert occ["waste_frac"] == round(1.0 - util, 4)
    assert abs(occ["waste_frac"] - rep.waste_frac) <= 5e-5
    assert plain.occupancy == occ and plain.device_phases == {}

    s = rep.summary()
    assert s["state_bytes_per_host"] == rep.memory["census"]["per_host"]
    assert s["lane_utilization"] == occ["utilization"]
    assert s["top_pass"] in dev["phases"]
    e = LG.entry_from_report("phold16", "fp", "cpu", rep)
    assert e["state_bytes_per_host"] == s["state_bytes_per_host"]
    assert e["top_pass"] == s["top_pass"]


def test_format_report_and_publish_keys_equal_reference():
    """The port's pass table and gauges carry the reference's keys:
    the same gauge names from one occupancy and one pass table, the same
    occupancy block, and the warning below the floor."""
    occ = PC.occupancy({"dense": (16, 516)}, 2426, 1)
    ms = 10**6          # ns per ms: the records' times are whole ms
    dev = PC.attribute([
        ("drain", False, 1, 0, 100 * ms, 1, 0),
        ("aten::add", False, 1, 10 * ms, 60 * ms, 2, 0),
        ("exchange", False, 1, 100 * ms, 200 * ms, 3, 0),
        ("aten::sort", False, 1, 110 * ms, 150 * ms, 4, 0),
        ("aten::copy_", False, 1, 300 * ms, 400 * ms, 5, 0),
    ], "cpu")
    dev.update(available=True, chunks_traced=1, device="cpu",
               trace_dir="x")
    assert dev["phases"]["drain"]["ms"] == 50.0
    assert dev["phases"]["drain"]["host_ms"] == 100.0
    assert dev["phases"]["exchange"]["ms"] == 40.0
    assert dev["total_ms"] == 190.0 and dev["residual_ms"] == 100.0
    assert not dev["ok"] and dev["residual_top"][0]["op"] == "aten::copy_"
    ours, theirs = Gauges(), Gauges()
    PC.publish(ours, occ=occ, dev=dev)
    RPC.publish(theirs, occ=occ, dev=dev)
    assert ours.vals == theirs.vals
    assert (PC.format_report(None, occ)
            == RPC.format_report(None, occ))
    text = PC.format_report(dev, occ)
    assert "passcope: device pass table" in text
    assert "WARNING: only" in text and "aten::copy_" in text
    for key in ("phases", "total_ms", "attributed_ms", "attributed_frac",
                "ok", "runtime_ms", "residual_ms", "residual_frac",
                "residual_label", "residual_top", "rungs"):
        assert key in dev
    assert PC.RESIDUAL == RPC.RESIDUAL
    assert PC.MIN_ATTRIBUTED == RPC.MIN_ATTRIBUTED
    assert PC.PASS_LABELS == RPC.PASS_LABELS


def test_cuda_waits_and_kernels_attribution():
    """On the card a kernel goes to the label of the op that launched
    it, the host's waits for the card go to runtime (and to the label's
    sync time), and device-to-host copies are runtime, not compute."""
    ms = 10**6
    recs = [(n, d, th, a * ms, b * ms, c, lk) for n, d, th, a, b, c, lk in [
        ("drain", False, 1, 0, 1000, 1, 0),
        ("aten::add", False, 1, 10, 110, 2, 0),
        ("cudaLaunchKernel", False, 9, 20, 30, 90, 2),
        ("add_kernel", True, 7, 500, 800, 91, 2),
        ("aten::item", False, 1, 200, 900, 3, 0),
        ("cudaStreamSynchronize", False, 9, 210, 890, 92, 3),
        ("Memcpy DtoH (Device -> Pageable)", True, 7, 880, 885, 93, 3),
        ("drain", True, 7, 0, 1000, 95, 1),    # the label's device range
        ("aten::mul", False, 1, 2000, 2100, 4, 0),
        ("mul_kernel", True, 7, 2100, 2200, 94, 4),
    ]]
    dev = PC.attribute(recs, "cuda")
    assert dev["phases"]["drain"]["ms"] == 300.0
    assert dev["phases"]["drain"]["sync_ms"] == 680.0
    assert dev["runtime_ms"] == 685.0
    assert dev["total_ms"] == 400.0
    assert dev["attributed_frac"] == 0.75 and not dev["ok"]
    assert dev["residual_top"] == [{"op": "aten::mul", "ms": 100.0}]
    # host issue time of the label: its range and ops, less the wait
    assert dev["phases"]["drain"]["host_ms"] == 200.0 + 100.0 + 20.0


def test_scope_is_free_when_off():
    """With no capture active a label is one shared no-op context."""
    assert not PC.ACTIVE
    assert PC.scope("drain") is PC.scope("exchange")
    with PC.scope("drain"):
        pass


def test_census_equals_reference_per_field():
    """Per field, the port's census of a config equals the reference's
    at wide_state=1 (the port's device state is wide), on
    tests/test_memscope.py's small shapes, with TCP and without; the
    live-tensor census equals the config-only one."""
    for extra in ({}, {"uses_tcp": False, "app_kinds": (0,)},
                  {"netscope": True, "tracecap": 8, "cpu_model": True}):
        cfg = EngineConfig(num_hosts=4, wide_state=1, **SMALL, **extra)
        rcfg = RefEngineConfig(num_hosts=4, wide_state=1, **SMALL, **extra)
        ours, theirs = MS.state_census(cfg), RMS.state_census(rcfg)
        assert ours == theirs
        assert MS.table_row_bytes(cfg) == RMS.table_row_bytes(rcfg)
        assert (MS.table_row_bytes(cfg, MS.HP_DIMS)
                == RMS.table_row_bytes(rcfg, RMS.HP_DIMS))
        assert MS.dims_of(cfg) == RMS.dims_of(rcfg)
        narrow = dataclasses.replace(cfg, wide_state=0)
        rnarrow = dataclasses.replace(rcfg, wide_state=0)
        assert MS.table_row_bytes(narrow) == RMS.table_row_bytes(rnarrow)
    from shadow_tpu_torch.engine.state import alloc_hosts
    live = MS.state_census(cfg, hosts=alloc_hosts(cfg, "cpu"))
    assert live["hosts"] == ours["hosts"]
    assert MS.HOSTS_DIMS == RMS.HOSTS_DIMS and MS.HP_DIMS == RMS.HP_DIMS
    assert MS.NARROW_DTYPES == RMS.NARROW_DTYPES


def test_run_census_shared_classification():
    """A built Simulation's census: Shared splits into per-host and
    fixed tables by name, HostParams by the live tensors, and
    SimReport.memory carries the reference's memory-record keys."""
    sim = Simulation(phold16(stop=1), device="cpu",
                     engine_cfg=EngineConfig(num_hosts=16, **PHOLD_CFG))
    c = MS.state_census(sim.cfg, hosts=sim.hosts, hp=sim.hp, sh=sim.sh)
    scaling = {f for f, v in c["shared"]["fields"].items()
               if v["scales_with_h"]}
    assert scaling == set(MS.SHARED_PER_HOST_FIELDS)
    assert c["hp"] == MS.state_census(sim.cfg)["hp"]
    rep = sim.run()
    for key in ("state_bytes", "state_bytes_per_host", "hot_state_bytes",
                "cold_state_bytes", "sections", "census", "peak_bytes"):
        assert key in rep.memory
    assert rep.memory["state_bytes"] == c["bytes"]


def test_cli_passcope_prints_the_table(tmp_path):
    """``--passcope DIR`` prints the pass table and the occupancy block
    and writes passcope.json, on the eager path; on the CPU
    ``--aot-cache`` runs as before and ``--prewarm`` captures nothing."""
    env = dict(os.environ, PYTHONPATH=str(REPO),
               SHADOW_TPU_PASSCOPE_CHUNKS="1")
    out = subprocess.run(
        [sys.executable, "-m", "shadow_tpu_torch", "examples/ping.xml",
         "--device", "cpu", "--passcope", str(tmp_path / "pc")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "passcope: device pass table" in out.stdout
    assert "occupancy: waste_frac=" in out.stdout
    assert (tmp_path / "pc" / "passcope.json").exists()
    outs = {}
    for flag in (["--aot-cache", str(tmp_path / "c"), "--summary-json"],
                 ["--prewarm"]):
        r = subprocess.run(
            [sys.executable, "-m", "shadow_tpu_torch", "examples/ping.xml",
             "--device", "cpu"] + flag,
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        outs[flag[-1]] = json.loads(r.stdout.strip().splitlines()[-1])
    s, warm = outs["--summary-json"], outs["--prewarm"]
    assert (s["path"], s["path_reason"], s["native_builds"]) == (
        "eager", "device cpu", 0)
    assert warm["captured"] is False and warm["path"] == "eager"


@pytest.mark.parametrize("device", ["cpu"])
def test_watermark_takes_its_device(device):
    """The watermark has no default device: the run passes its own."""
    import inspect
    sig = inspect.signature(MS.Watermark)
    assert sig.parameters["device"].default is inspect.Parameter.empty
    wm = MS.Watermark(torch.device(device))
    assert wm.snapshot()["source"] == "rss"
