"""Determinism flight recorder: windowed state digests + run manifest.

Counterpart of ``shadow_tpu/obs/digest.py``, record for record: every
`every` windows, at every fault boundary and at the end of a run, the
Hosts tensors are pulled to the host once (declaration order), dead
slots are zeroed (``engine.window.canonicalize_state``), and each state
section (``engine.state.STATE_SECTIONS``) is hashed over every field's
name, dtype, shape and raw bytes. One JSON line per record carries the
section hashes, per-host hashes at small host counts and a running
chain hash over all earlier records. The port's state is the
reference's canonical wide form, so the same run gives the same chain
in both packages; ``tools/divergence.py`` diffs two chains and names
the first divergent window and section.

A ``<path>.manifest.json`` companion records the seed, the scenario
fingerprint, the engine config, the platform and versions.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

ENABLED = False
RECORDER = None

# default cadence, in windows
DEFAULT_EVERY = 64

# per-host digests up to this host count (SHADOW_TPU_DIGEST_HOSTS)
DEFAULT_HOST_DETAIL = 1024

_CHAIN_SEED = b"shadow_tpu.digest.v1"


def _hash_arrays(arrs: dict, H: int, host_detail: int):
    """-> (sections hex dict, per-host hex list or None, bytes hashed).
    `arrs` maps field -> canonicalized [:H] numpy array in Hosts field
    order. Zero-size columns (a disabled feature's) are skipped."""
    from ..engine.state import section_of

    sections = {}
    host_hashers = ([hashlib.blake2b(digest_size=4) for _ in range(H)]
                    if 0 < H <= host_detail else None)
    nbytes = 0
    for name, a in arrs.items():
        if a.size == 0:
            continue
        sec = sections.get(section_of(name))
        if sec is None:
            sec = sections[section_of(name)] = hashlib.blake2b(
                digest_size=8)
        sec.update(f"{name}:{a.dtype.str}:{a.shape}".encode())
        buf = np.ascontiguousarray(a)
        sec.update(buf)
        nbytes += buf.nbytes
        if host_hashers is not None:
            for i in range(H):
                host_hashers[i].update(buf[i])
    out = {k: h.hexdigest() for k, h in sorted(sections.items())}
    hosts_hex = ([h.hexdigest() for h in host_hashers]
                 if host_hashers is not None else None)
    return out, hosts_hex, nbytes


def _dump(rec: dict) -> str:
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))


class DigestRecorder:
    """One digest chain. `path=None` collects in memory only. A
    recorder that is not the `writer` (a process of a multi-process mesh
    other than process 0) keeps the chain in lockstep, reading the file
    on resume, but never writes it."""

    def __init__(self, path: str | None, every: int = DEFAULT_EVERY,
                 context: dict = None, writer: bool = True):
        self.path = path
        self.writer = writer
        self.every = max(int(every), 1)
        self.host_detail = int(os.environ.get(
            "SHADOW_TPU_DIGEST_HOSTS", str(DEFAULT_HOST_DETAIL)))
        self.context = dict(context or {})
        self.records = []
        self.manifest = None
        self.bytes_hashed = 0
        self.record_wall = 0.0      # host wall spent in record()
        self._chain = _CHAIN_SEED
        self._file = None
        self._mode = "w"
        self.next_due = self.every

    # --- cadence ---
    def due(self, total_windows: int) -> bool:
        return total_windows >= self.next_due

    def begin_run(self, total_windows: int):
        """Re-arm the cadence for a (re)starting run."""
        self.next_due = int(total_windows) + self.every

    @property
    def chain_hex(self) -> str:
        """The running chain hash, stamped into checkpoints."""
        return self._chain.hex()

    def rewind(self, n_records: int, chain_hex: str = None):
        """Resume the chain a crashed attempt left: keep exactly the
        first `n_records` records of the chain file (the count the
        checkpoint stamped), verify that they refold to `chain_hex`,
        truncate the file to them and re-arm the cadence as the
        uninterrupted run's was. Later records append, so the final
        chain equals an uninterrupted run's byte for byte."""
        n = max(int(n_records), 0)
        kept = []
        if self.path is not None and os.path.exists(self.path):
            assert self._file is None, "rewind() must precede records"
            with open(self.path) as f:
                lines = f.read().splitlines()
            for i, line in enumerate(lines):
                if len(kept) >= n:
                    break
                if not line.strip():
                    continue
                try:
                    kept.append(json.loads(line))
                except json.JSONDecodeError:
                    raise ValueError(
                        f"digest chain {self.path}: line {i + 1} is "
                        "corrupt inside the checkpointed prefix "
                        f"({len(kept)}/{n} records); refusing to "
                        "resume it")
        if len(kept) < n:
            raise ValueError(
                f"digest chain {self.path} holds {len(kept)} records "
                f"but the checkpoint was taken after {n} — the chain "
                "file does not belong to this run")
        chain = _CHAIN_SEED
        for rec in kept:
            body = {k: v for k, v in rec.items() if k != "chain"}
            chain = hashlib.blake2b(chain + _dump(body).encode(),
                                    digest_size=16).digest()
            if rec.get("chain") != chain.hex():
                raise ValueError(
                    f"digest chain {self.path}: record at window "
                    f"{rec.get('window')} does not refold — the "
                    "prefix is corrupted; delete the chain and record "
                    "fresh")
        if chain_hex and chain.hex() != chain_hex:
            raise ValueError(
                f"digest chain {self.path}: the {n}-record prefix "
                "refolds to a different chain hash than the "
                "checkpoint stamped — chain and snapshot are from "
                "different runs")
        self._chain = chain
        self.records = kept
        if self.path is not None and self.writer:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                for rec in kept:
                    f.write(_dump(rec) + "\n")
            os.replace(tmp, self.path)
        self._mode = "a"
        self.next_due = ((kept[-1]["window"] + self.every) if kept
                         else self.every)

    # --- manifest ---
    def manifest_path(self) -> str | None:
        return self.path + ".manifest.json" if self.path else None

    def write_manifest(self, manifest: dict):
        """Record (and persist) the run manifest; the first run wins."""
        if self.manifest is not None:
            return
        self.manifest = manifest
        mp = self.manifest_path()
        if mp is not None and self.writer:
            tmp = mp + ".tmp"
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
            os.replace(tmp, mp)

    # --- recording ---
    def record(self, hosts, H: int, window: int, sim_ns: int,
               kind: str, hosted: dict = None) -> dict:
        """Hash `hosts` (a port Hosts; one copy to the host per field)
        into one chain record. `hosted` is the hosting runtime's
        op-stream digests (``HostingRuntime.digest_state``), in hosted
        runs: the record carries it and its hash as section
        ``hosted``."""
        import time

        from ..engine.checkpoint import named_leaves
        from ..engine.window import canonicalize_state

        t0 = time.perf_counter()
        arrs = {name: t.cpu().numpy()[:H]
                for name, t in named_leaves(hosts)}
        arrs = canonicalize_state(arrs)
        sections, hosts_hex, nbytes = _hash_arrays(arrs, H,
                                                   self.host_detail)
        self.bytes_hashed += nbytes
        rec = {"window": int(window), "sim_ns": int(sim_ns),
               "kind": kind, "sections": sections}
        if hosted is not None:
            rec["hosted"] = hosted
            h = hashlib.blake2b(json.dumps(hosted, sort_keys=True).encode(),
                                digest_size=8)
            rec["sections"] = dict(sections, hosted=h.hexdigest())
        if hosts_hex is not None:
            rec["hosts"] = hosts_hex
        self._chain = hashlib.blake2b(self._chain + _dump(rec).encode(),
                                      digest_size=16).digest()
        rec["chain"] = self._chain.hex()
        self.records.append(rec)
        if self.path is not None and self.writer:
            if self._file is None:
                self._file = open(self.path, self._mode)
            self._file.write(_dump(rec) + "\n")
            self._file.flush()
        self.next_due = int(window) + self.every
        self.record_wall += time.perf_counter() - t0
        return rec

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


def build_manifest(scenario, cfg, seed: int, sh, host_names: list,
                   recorder: DigestRecorder, device,
                   checkpoint_path: str = None, shards: int = 1,
                   pcap: bool = False, faults: bool = False,
                   hosted: bool = False) -> dict:
    """What decides that two chains are comparable: the reference's
    manifest keys, with the torch device and versions. `shards` is the
    mesh size of a sharded run."""
    import platform as _platform
    import sys as _sys

    import torch

    from ..engine.checkpoint import scenario_fingerprint

    cfgd = dataclasses.asdict(cfg)
    if cfgd.get("app_kinds") is not None:
        cfgd["app_kinds"] = list(cfgd["app_kinds"])
    return {
        "format": "shadow_tpu.digest.manifest", "version": 1,
        "seed": int(seed),
        "fingerprint": scenario_fingerprint(scenario, cfg, seed),
        "config_path": recorder.context.get(
            "config_path", getattr(scenario, "source_path", None)),
        "argv": recorder.context.get("argv"),
        "stop_time_ns": int(scenario.stop_time),
        "min_jump_ns": int(sh.min_jump),
        "tcp": {"cc_kind": int(sh.cc_kind),
                "init_wnd": float(sh.tcp_init_wnd),
                "ssthresh0": float(sh.tcp_ssthresh0)},
        "hosts": len(host_names),
        "host_names": (list(host_names)
                       if len(host_names) <= recorder.host_detail
                       else None),
        "engine_config": cfgd,
        "digest_every": recorder.every,
        "host_detail": recorder.host_detail,
        "shards": int(shards),
        # pcap drains reset the trace rings chunk-wise: a pcap run's
        # trace_ring section differs from a plain run's
        "pcap": bool(pcap),
        "faults": bool(faults),
        "hosted": bool(hosted),
        "platform": str(device),
        "versions": {"python": _sys.version.split()[0],
                     "torch": torch.__version__,
                     "numpy": np.__version__,
                     "os": _platform.platform()},
        "git_rev": _git_rev(),
        "checkpoint_path": checkpoint_path,
    }


def _git_rev() -> str | None:
    import subprocess
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True,
            text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        return out.stdout.strip() or None
    except Exception:
        return None


def install(path: str | None, every: int = DEFAULT_EVERY,
            context: dict = None, writer: bool = True) -> DigestRecorder:
    """Enable recording process-wide; the installer owns finish()."""
    global ENABLED, RECORDER
    RECORDER = DigestRecorder(path, every=every, context=context,
                              writer=writer)
    ENABLED = True
    return RECORDER


def finish() -> DigestRecorder | None:
    """Disable recording, close the chain file, return the recorder."""
    global ENABLED, RECORDER
    rec, RECORDER, ENABLED = RECORDER, None, False
    if rec is not None:
        rec.close()
    return rec
