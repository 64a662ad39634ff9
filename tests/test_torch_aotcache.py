"""The port's disk tier and pre-warm machinery, with an injected builder
in place of nvcc: the copies of tests/test_serving.py's machinery tests
for ``shadow_tpu_torch/serving/aotcache.py`` (the nvcc-built kernel
library's store) and ``serving/prewarm.py`` (the fleet's pre-warm
pipeline). Nothing here needs a card or a compiler: the builder writes
bytes, and the probe and warm children are small python commands."""

import json
import os
import sys
import time

import pytest

from shadow_tpu_torch.fleet.queue import Queue, make_spec
from shadow_tpu_torch.serving import aotcache as AC
from shadow_tpu_torch.serving.prewarm import Prewarmer, probe_argv, warm_argv

PLATFORM = {"nvcc": "Build cuda_12.9", "torch": "2.11.0+cu128",
            "torch_cuda": "12.8", "device": "NVIDIA H100 80GB HBM3",
            "capability": "9.0"}
SIG = {"arch": "sm_90a", "flags": ["-O3"]}


class Builder:
    """Writes `payload` to the output path and counts its calls."""

    def __init__(self, payload=b"\x7fELF-lib"):
        self.payload = payload
        self.calls = 0

    def __call__(self, out):
        self.calls += 1
        with open(out, "wb") as f:
            f.write(self.payload)


def _get(tmp_path, builder, platform=PLATFORM, source="s1", keep=None):
    store = AC.DiskCache(str(tmp_path / "cache"), keep=keep)
    return AC.load_or_build("flow", SIG, builder, platform=platform,
                            source=source, store=store)


def _delta(before, *keys):
    return {k: AC.STATS[k] - before[k] for k in keys}


@pytest.fixture(autouse=True)
def no_active_cache():
    AC.uninstall()
    yield
    AC.uninstall()


def test_key_anatomy():
    """Stale rejection is structural: a different scope, build
    signature, nvcc, torch, CUDA, device or source digest computes a
    different key, so the stale library is unreachable."""
    base = AC.entry_key("flow", SIG, PLATFORM, "s1")
    assert base == AC.entry_key("flow", dict(SIG), dict(PLATFORM), "s1")
    others = {AC.entry_key("other", SIG, PLATFORM, "s1"),
              AC.entry_key("flow", {**SIG, "arch": "sm_90"}, PLATFORM, "s1"),
              AC.entry_key("flow", SIG, PLATFORM, "s2")}
    for k in PLATFORM:
        others.add(AC.entry_key("flow", SIG, {**PLATFORM, k: "skew"}, "s1"))
    assert base not in others and len(others) == 3 + len(PLATFORM)
    # the source digest covers the native sources, by name and content
    src = AC.source_digest()
    assert len(src) == 16 and src == AC.source_digest()
    meta = AC.key_meta("flow", SIG, PLATFORM, "s1")
    assert meta["platform"] == PLATFORM and meta["source"] == "s1"


def test_round_trip_and_bad_entries_rebuild_loudly(tmp_path, capsys):
    """A fresh process stand-in loads the stored library instead of
    building it; a torn or corrupt payload, a lost hash sidecar and an
    alien meta sidecar each rebuild loudly and replace the entry."""
    b = Builder()
    before = dict(AC.STATS)
    p1 = _get(tmp_path, b)
    assert b.calls == 1 and open(p1, "rb").read() == b.payload
    assert _delta(before, "builds", "disk_stores", "disk_hits") == {
        "builds": 1, "disk_stores": 1, "disk_hits": 0}
    assert os.path.exists(p1 + ".sha256")
    assert os.path.exists(p1[:-len(AC.SUFFIX)] + ".meta.json")
    before = dict(AC.STATS)
    assert _get(tmp_path, b) == p1 and b.calls == 1
    assert _delta(before, "builds", "disk_hits") == {"builds": 0,
                                                     "disk_hits": 1}

    def corrupt(p):
        with open(p, "r+b") as f:
            f.write(b"X")

    def torn(p):
        with open(p, "wb") as f:
            f.write(b"\x7fE")

    def lost_hash(p):
        os.unlink(p + ".sha256")

    def alien(p):
        m = p[:-len(AC.SUFFIX)] + ".meta.json"
        d = json.load(open(m))
        d["platform"] = {**d["platform"], "device": "another card"}
        json.dump(d, open(m, "w"))

    for spoil in (corrupt, torn, lost_hash, alien):
        spoil(p1)
        before = dict(AC.STATS)
        calls = b.calls
        assert _get(tmp_path, b) == p1
        assert b.calls == calls + 1, spoil.__name__
        assert _delta(before, "rejected", "builds") == {"rejected": 1,
                                                        "builds": 1}
        assert "rebuilding and dropping the entry" in capsys.readouterr().err
        assert open(p1, "rb").read() == b.payload


def test_version_skew_never_loads(tmp_path):
    """An entry built by another toolchain or for another card is never
    loaded: the key differs, so it misses and builds its own."""
    b = Builder()
    p1 = _get(tmp_path, b)
    for k in ("nvcc", "torch", "device"):
        before = dict(AC.STATS)
        p = _get(tmp_path, b, platform={**PLATFORM, k: "skewed " + k})
        assert p != p1
        assert _delta(before, "builds", "disk_hits", "disk_misses") == {
            "builds": 1, "disk_hits": 0, "disk_misses": 1}
    assert _get(tmp_path, b, source="edited") != p1
    assert open(p1, "rb").read() == b.payload


def test_retention_prunes_the_oldest(tmp_path):
    """Past `keep` entries, the oldest by mtime go, with their
    sidecars; the keep variable sets the default."""
    b = Builder()
    paths = []
    for i in range(4):
        paths.append(_get(tmp_path, b, source=f"s{i}", keep=2))
        os.utime(paths[-1], (1000 + i, 1000 + i))
    dc = AC.DiskCache(str(tmp_path / "cache"), keep=2)
    assert [dc.path(k) for k in dc.entries()] == paths[2:]
    assert not os.path.exists(paths[0] + ".sha256")
    os.environ[AC.KEEP_ENV] = "5"
    try:
        assert AC.DiskCache(str(tmp_path / "x")).keep == 5
    finally:
        del os.environ[AC.KEEP_ENV]


def test_first_writer_wins(tmp_path):
    """A complete entry is never overwritten, and a live writer's lock
    keeps a second writer out (it keeps its own copy, loaded from a
    private file); a dead writer's stale lock is broken."""
    dc = AC.DiskCache(str(tmp_path / "cache"))
    key = AC.entry_key("flow", SIG, PLATFORM, "s1")
    assert dc.store(key, b"first") == dc.path(key)
    assert dc.store(key, b"second") is None
    assert open(dc.path(key), "rb").read() == b"first"
    # a live writer holds the next key's lock
    key2 = AC.entry_key("flow", SIG, PLATFORM, "s2")
    lock = dc.path(key2) + ".lock"
    open(lock, "w").close()
    b = Builder(b"mine")
    p = _get(tmp_path, b, source="s2")
    assert p != dc.path(key2) and open(p, "rb").read() == b"mine"
    assert not dc.has(key2)
    # a writer dead for longer than LOCK_STALE_S: its lock is broken
    old = time.time() - 2 * dc.LOCK_STALE_S
    os.utime(lock, (old, old))
    assert dc.store(key2, b"mine") == dc.path(key2)
    assert not os.path.exists(lock)


def test_env_variable_activates_the_cache(tmp_path, monkeypatch):
    """SHADOW_TPU_TORCH_AOT_CACHE installs the tier once a process (the
    fleet children's route); without it the checkout's build/kernels
    directory is used."""
    AC.ACTIVE, AC._ENV_CHECKED = None, False
    monkeypatch.setenv(AC.ENV, str(tmp_path / "envcache"))
    assert AC.active().root == str(tmp_path / "envcache")
    assert AC.cache().root == str(tmp_path / "envcache")
    AC.uninstall()
    assert AC.active() is None
    assert AC.cache().root.endswith(os.path.join("build", "kernels"))


def _fake_probe(python, spec):
    """Prints the shape encoded in the spec's config path
    ('name~SHAPE'), like the real --shape-fingerprint child."""
    fp = spec["config"].split("~")[-1]
    return [sys.executable, "-c",
            "import json; print(json.dumps("
            f"{{'shape_fingerprint': {fp!r}}}))"]


def _drive(pw, timeout_s=30.0):
    t0 = time.monotonic()
    while not pw.done():
        pw.tick()
        if time.monotonic() - t0 > timeout_s:
            pw.shutdown()
            raise AssertionError("prewarm pipeline did not drain")
        time.sleep(0.02)
    pw.tick()


def test_prewarmer_dedups_shapes_and_gates_admission(tmp_path):
    """3 runs, 2 shapes: every run gates until its shape warms, each
    distinct shape warms exactly once, and the children run as
    ``python -m shadow_tpu_torch`` on the run's device with its digest
    cadence (which sets the chunk)."""
    marks = tmp_path / "warms"
    marks.mkdir()

    def warm_fn(python, spec, cache_dir):
        fp = spec["config"].split("~")[-1]
        return [sys.executable, "-c",
                f"open({str(marks / fp)!r}, 'a').write('x')"]

    specs = [{"id": "r1", "config": "a~shapeX"},
             {"id": "r2", "config": "b~shapeX"},
             {"id": "r3", "config": "c~shapeY"},
             {"id": "cmd1", "config": None, "cmd": ["true"]}]
    records = []
    pw = Prewarmer(specs, str(tmp_path / "cache"), jobs=2,
                   log=lambda m: None,
                   journal=lambda **kw: records.append(kw),
                   probe_fn=_fake_probe, warm_fn=warm_fn)
    assert pw.ready("cmd1")
    assert not pw.ready("r1") and not pw.ready("r3")
    _drive(pw)
    assert pw.ready("r1") and pw.ready("r2") and pw.ready("r3")
    assert sorted(os.listdir(marks)) == ["shapeX", "shapeY"]
    assert {r["shape"] for r in records
            if r.get("state") == "warmed"} == {"shapeX", "shapeY"}
    assert {r["run"] for r in records
            if r.get("state") == "resolved"} == {"r1", "r2", "r3"}
    assert pw.counts() == {"warmed": 2, "failed": 0, "warming": 0,
                           "probing": 0}
    spec = {"id": "r1", "config": "/tmp/a.xml", "args": ["--seed", "3"],
            "device": "cpu", "digest": True, "digest_every": 8}
    p = " ".join(probe_argv(None, spec))
    assert "-m shadow_tpu_torch /tmp/a.xml --seed 3 --device cpu" in p
    assert p.endswith("--digest-every 8 --shape-fingerprint")
    w = " ".join(warm_argv(None, spec, "/tmp/cache"))
    assert "--aot-cache /tmp/cache --prewarm" in w
    assert "--digest-every 8" in w


def test_prewarm_failures_never_wedge_admission(tmp_path):
    """A failed probe, a failed warm and a hung probe (killed past its
    deadline) each admit the run anyway: pre-warm is an optimization,
    never a gate that can starve the queue. The queue folds the
    ``prewarm`` records apart from the runs' states."""
    pw = Prewarmer([{"id": "r1", "config": "a~x"}], str(tmp_path / "c"),
                   log=lambda m: None,
                   probe_fn=lambda py, s: [sys.executable, "-c",
                                           "raise SystemExit(3)"],
                   warm_fn=_fake_probe)
    _drive(pw)
    assert pw.ready("r1")
    q = Queue(str(tmp_path / "q")).ensure()
    q.submit(make_spec("r2", cmd=["true"]))
    pw = Prewarmer([{"id": "r2", "config": "b~shapeZ"}],
                   str(tmp_path / "c"), log=lambda m: None,
                   journal=lambda **kw: q.append("prewarm", **kw),
                   probe_fn=_fake_probe,
                   warm_fn=lambda py, s, d: [sys.executable, "-c",
                                             "raise SystemExit(2)"])
    _drive(pw)
    assert pw.ready("r2")
    assert q.prewarm_fold() == {"shapes": {"shapeZ": "failed"},
                                "runs": {"r2": "shapeZ"}}
    states = q.fold()
    assert set(states) == {"r2"} and states["r2"].state == "queued"
    pw = Prewarmer([{"id": "r3", "config": "c~y"}], str(tmp_path / "c"),
                   log=lambda m: None, probe_timeout_s=0.5,
                   probe_fn=lambda py, s: [sys.executable, "-c",
                                           "import time; time.sleep(600)"],
                   warm_fn=_fake_probe)
    _drive(pw, timeout_s=20.0)
    assert pw.ready("r3")
