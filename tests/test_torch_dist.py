"""The port's mesh over two processes (``shadow_tpu_torch/parallel/
dist.py``): tests/test_distributed.py's contract in the port.

Two OS processes, each holding 2 shards on the CPU, join one
``torch.distributed`` group over gloo on loopback and run one 4-shard
mesh of the reference's multi-process phold shape
(tests/helpers/scenario_phold.py): stats, the digest chain and the pcap
bytes must equal the single-process run's, and a run killed mid-way
resumes from its global snapshot onto a fresh two-process mesh with the
uninterrupted chain. Every ``communicate`` has a timeout, and every peer
is reaped before any assert.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

HELPERS = Path(__file__).resolve().parent / "helpers"
sys.path.insert(0, str(HELPERS))
import torch_dist_worker as W  # noqa: E402

from shadow_tpu_torch.engine.checkpoint import resolve_latest  # noqa: E402
from shadow_tpu_torch.engine.sim import Simulation  # noqa: E402
from torch_threads import one_torch_thread_everywhere  # noqa: E402,F401


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(out, extra, tag, expect_signal=None):
    """Two ranks of the worker; every one reaped before the asserts."""
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(HELPERS / "torch_dist_worker.py"), coord, "2",
         str(pid), str(out)] + extra,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=240)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    want = -expect_signal if expect_signal else 0
    for pid, (p, text) in enumerate(zip(procs, outputs)):
        assert p.returncode == want, (
            f"{tag} proc {pid} exited {p.returncode} (wanted {want}):\n"
            f"{text[-3000:]}")
    return outputs


def _single(**kw):
    return Simulation(W.port_scenario(pcap="pcap_dir" in kw),
                      engine_cfg=W.port_cfg(), device="cpu").run(**kw)


def test_two_process_mesh_matches_single(tmp_path):
    """Stats and the digest chain, record for record; rank 0 writes. A
    fault schedule is refused on the mesh, as in the reference."""
    chain = str(tmp_path / "single.jsonl")
    truth = _single(digest=chain, digest_every=8)
    assert truth.events > 0
    out, multi = tmp_path / "stats.npy", str(tmp_path / "multi.jsonl")
    texts = _spawn(out, ["--digest", multi, "--refusals"], "fresh")
    assert all("4 shards" in t and "backend gloo" in t for t in texts)
    assert all("refused: fault injection + multi-process mesh not "
               "supported" in t for t in texts)
    assert np.array_equal(np.load(out), truth.stats)
    a, b = Path(chain).read_bytes(), Path(multi).read_bytes()
    assert a and a == b


def test_two_process_checkpoint_resume(tmp_path):
    """Killed at 2 sim-s after its snapshots, the run resumes from the
    global snapshot (rank 0 wrote it) onto a fresh two-process mesh:
    the single run's stats and chain."""
    chain = str(tmp_path / "single.jsonl")
    truth = _single(digest=chain, digest_every=8)
    ckpt, multi = str(tmp_path / "snap"), str(tmp_path / "multi.jsonl")
    _spawn(tmp_path / "a.npy", ["--ckpt", ckpt, "--digest", multi,
                                "--crash-ns", "2000000000"],
           "crashing", expect_signal=9)
    assert resolve_latest(ckpt), "crashed before the first snapshot"
    assert Path(multi).read_bytes()
    out = tmp_path / "b.npy"
    _spawn(out, ["--ckpt", ckpt, "--resume", "--digest", multi],
           "resuming")
    assert np.array_equal(np.load(out), truth.stats)
    assert Path(chain).read_bytes() == Path(multi).read_bytes()


def test_two_process_pcap_matches_single(tmp_path):
    """The trace rings gather each chunk and rank 0 writes the pcap
    files: the single run's bytes."""
    single_dir, multi_dir = tmp_path / "single", tmp_path / "multi"
    truth = _single(pcap_dir=str(single_dir))
    names = sorted(os.listdir(single_dir))
    assert names
    out = tmp_path / "stats.npy"
    _spawn(out, ["--pcap", str(multi_dir)], "pcap")
    assert np.array_equal(np.load(out), truth.stats)
    assert sorted(os.listdir(multi_dir)) == names
    for name in names:
        assert (single_dir / name).read_bytes() == \
            (multi_dir / name).read_bytes(), name
