"""The port's checkpoint store (``shadow_tpu_torch/engine/checkpoint.py``)
against the reference's format and behaviour.

The store keeps the reference's durability contract (atomic saves,
corrupt-head fallback, retention, hard layout errors) and its file
format: leaves in ``jax.tree.flatten`` order and at-rest dtypes, the
same scenario fingerprint, so a snapshot written by either package
resumes in the other with a digest chain equal to the uninterrupted
run's. The whole runs share tests/test_checkpoint.py's phold shape, so
the reference compiles once for the file.
"""

import os

import jax
import numpy as np
import pytest

from shadow_tpu.core.config import FaultSpec
from shadow_tpu.core.config import load_xml as ref_load_xml
from shadow_tpu.engine import checkpoint as ref_ck
from shadow_tpu.engine.sim import Simulation as RefSimulation
from shadow_tpu.engine.state import EngineConfig as RefEngineConfig
from shadow_tpu.engine.state import alloc_hosts as ref_alloc_hosts

from shadow_tpu_torch.core.config import load_xml
from shadow_tpu_torch.engine import checkpoint as ck
from shadow_tpu_torch.engine.sim import Simulation
from shadow_tpu_torch.engine.state import (EngineConfig, alloc_hosts,
                                           narrow_arrays, widen_arrays)

from test_checkpoint import CFG, scen
from test_cpu_model import scen as cpu_scen
from test_faults import ping_scenario
from test_torch_parity import one_torch_thread  # noqa: F401


def _tiny_hosts(**kw):
    return alloc_hosts(EngineConfig(num_hosts=2, **dict(
        dict(qcap=4, scap=2, obcap=4, incap=8), **kw)), "cpu")


def test_store_atomicity_kill_mid_save(tmp_path):
    """A torn ``.tmp`` from a kill mid-save never resolves, and the next
    save's prune removes it."""
    hosts = _tiny_hosts()
    store = ck.CheckpointStore(str(tmp_path / "ck.npz"), keep=3)
    good = store.save(hosts, 100, 200, 1, "fp")
    torn = str(tmp_path / "ck.w0000000099.npz.tmp")
    with open(torn, "wb") as f:
        f.write(b"\x50\x4b\x03\x04 truncated npz")
    assert ck.resolve_latest(str(tmp_path / "ck.npz")) == good
    snap = ck.load(str(tmp_path / "ck"), hosts, "fp")
    assert (snap.wstart, snap.windows) == (100, 1)
    store.save(hosts, 300, 400, 2, "fp")
    assert not os.path.exists(torn)


def test_store_corrupt_head_falls_back(tmp_path, capsys):
    hosts = _tiny_hosts()
    store = ck.CheckpointStore(str(tmp_path / "ck"), keep=3)
    prev = store.save(hosts, 100, 200, 1, "fp")
    head = store.save(hosts, 300, 400, 2, "fp")
    with open(head, "r+b") as f:
        f.truncate(64)
    assert ck.resolve_latest(str(tmp_path / "ck")) == prev
    assert ck.load(str(tmp_path / "ck"), hosts, "fp").wstart == 100
    err = capsys.readouterr().err
    assert "content hash" in err and "falling back" in err


def test_store_retention(tmp_path):
    hosts = _tiny_hosts()
    store = ck.CheckpointStore(str(tmp_path / "ck"), keep=2)
    paths = [store.save(hosts, 100 * i, 0, i, "fp") for i in range(1, 4)]
    assert not os.path.exists(paths[0])
    assert os.path.exists(paths[1]) and os.path.exists(paths[2])
    assert ck.resolve_latest(str(tmp_path / "ck")) == paths[2]


def test_shape_mismatch_always_hard_error(tmp_path):
    """The layout check comes before the fingerprint check, and
    strict=False never softens it."""
    store = ck.CheckpointStore(str(tmp_path / "ck"), keep=3)
    f = store.save(_tiny_hosts(), 100, 200, 1, "fp")
    with pytest.raises(ValueError) as ei:
        ck.load(f, _tiny_hosts(qcap=8), "DIFFERENT-FP", strict=False)
    msg = str(ei.value)
    assert "layout mismatch" in msg
    assert "(2, 4" in msg and "(2, 8" in msg


def test_leaves_in_reference_flatten_order_and_dtypes(tmp_path):
    """leafN is the reference's jax.tree.flatten order, each in the
    reference's at-rest dtype and shape (narrow at wide_state=0, wide
    at 1), and the narrow codec round-trips a live state exactly."""
    for wide in (0, 1):
        kw = dict(num_hosts=3, qcap=8, scap=4, obcap=4, incap=8,
                  wide_state=wide)
        ref = ref_alloc_hosts(RefEngineConfig(**kw))
        leaves, _ = jax.tree.flatten(ref)
        by_id = {id(a): n for n, a in ref_ck.named_leaves(ref)}
        names = [by_id[id(a)] for a in leaves]
        hosts = alloc_hosts(EngineConfig(**kw), "cpu")
        assert ck.flatten_order(hosts) == names
        path = ck.CheckpointStore(str(tmp_path / f"w{wide}")).save(
            hosts, 0, 0, 0, "fp", narrow=not wide)
        with np.load(path) as z:
            for i, a in enumerate(leaves):
                assert (z[f"leaf{i}"].dtype, z[f"leaf{i}"].shape) == (
                    np.asarray(a).dtype, a.shape), names[i]
    sim = Simulation(scen(), engine_cfg=EngineConfig(num_hosts=8, **CFG),
                     device="cpu")
    sim.run()
    live = sim.final_hosts.numpy()
    back = widen_arrays(narrow_arrays(live))
    assert all(np.array_equal(back[f], live[f]) for f in live)


def test_fingerprint_matches_reference():
    """Same scenario and config -> the reference's fingerprint, for a
    plain, a faulted and a CPU-model scenario."""
    faults = [FaultSpec(kind="loss", at=3 * 10**9, until=5 * 10**9,
                        rate=0.5, src="server", dst="client")]
    for make in (scen, lambda: ping_scenario(faults),
                 lambda: cpu_scen(freq_khz=30_000, threshold_ns=1000)):
        r = RefSimulation(make())
        p = Simulation(make(), device="cpu")
        assert repr(p.scenario) == repr(r.scenario)
        assert ck.scenario_fingerprint(p.scenario, p.cfg, p.seed) == \
            ref_ck.scenario_fingerprint(r.scenario, r.cfg, r.seed)
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "faults-demo.xml")
    assert repr(load_xml(path)) == repr(ref_load_xml(path))


def _uninterrupted_chain(tmp_path):
    a = str(tmp_path / "a.jsonl")
    RefSimulation(scen(), engine_cfg=RefEngineConfig(num_hosts=8, **CFG)
                  ).run(digest=a, digest_every=8)
    return a


def _cut_at_first_snapshot(store_mod, base, chain):
    """The state a kill just after the first mid-run save leaves: the
    chain one record past the snapshot's stamped position."""
    snap = sorted(store_mod.CheckpointStore(base).snapshots())[0]
    n = int(np.load(snap)["__digest_records__"])
    lines = open(chain).read().splitlines()
    assert n + 1 < len(lines), "snapshot too late for this test"
    with open(chain, "w") as f:
        f.write("\n".join(lines[:n + 1]) + "\n")
    return snap


def test_reference_snapshot_resumes_in_port(tmp_path):
    a = _uninterrupted_chain(tmp_path)
    base, b = str(tmp_path / "ck"), str(tmp_path / "b.jsonl")
    RefSimulation(scen(), engine_cfg=RefEngineConfig(num_hosts=8, **CFG)
                  ).run(digest=b, digest_every=8, checkpoint_path=base,
                        checkpoint_every_s=2, checkpoint_keep=8)
    snap = _cut_at_first_snapshot(ref_ck, base, b)
    rep = Simulation(scen(), engine_cfg=EngineConfig(num_hosts=8, **CFG),
                     device="cpu").run(digest=b, digest_every=8,
                                       resume_from=snap)
    assert rep.windows > 0 and rep.durability["load_s"] is not None
    assert open(a, "rb").read() == open(b, "rb").read()


def test_port_snapshot_resumes_in_reference(tmp_path):
    a = _uninterrupted_chain(tmp_path)
    base, c = str(tmp_path / "ck"), str(tmp_path / "c.jsonl")
    rep = Simulation(scen(), engine_cfg=EngineConfig(num_hosts=8, **CFG),
                     device="cpu").run(digest=c, digest_every=8,
                                       checkpoint_path=base,
                                       checkpoint_every_s=2,
                                       checkpoint_keep=8)
    assert len(rep.durability["saves"]) >= 2
    assert open(a, "rb").read() == open(c, "rb").read()
    snap = _cut_at_first_snapshot(ck, base, c)
    assert ref_ck.resolve_latest(base) is not None
    RefSimulation(scen(), engine_cfg=RefEngineConfig(num_hosts=8, **CFG)
                  ).run(digest=c, digest_every=8, resume_from=snap)
    assert open(a, "rb").read() == open(c, "rb").read()
