"""Crash-safe checkpoint/resume: snapshot the Hosts state.

Counterpart of ``shadow_tpu/engine/checkpoint.py``, in its file format,
so a snapshot written by either package resumes in the other:

- one ``.npz`` per snapshot, ``<base>.w<windows>.npz``, holding the
  Hosts fields as ``leaf0..leaf81`` in the reference's pytree flatten
  order (the field names sorted) and in its at-rest dtypes (narrow when
  ``EngineConfig.wide_state == 0``, its default; ``state.NARROW_SPEC``),
  plus the ``__fingerprint__``, ``__wstart__``, ``__wend__``,
  ``__windows__``, ``__fault_idx__``, ``__digest_records__``,
  ``__digest_chain__`` and ``__hosted_sha__`` stamps;
- hosted runs add a ``<file>.hosted`` sidecar, the hosting runtime's
  pickled snapshot (the port's own classes, so only the port reads
  it), whose sha256 the npz stamps in ``__hosted_sha__``;
- a save is atomic: the npz is written to ``<file>.tmp`` and fsynced,
  its ``.sha256`` and ``.hosted`` sidecars are written, then
  ``os.replace`` publishes the npz and the ``<base>.latest`` pointer
  flips last;
- the last ``keep`` snapshots are kept; a corrupt head falls back
  loudly to the newest older snapshot that verifies.

The device state is always wide: the codec runs on the host, on save
and on load.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import re
import sys
import zipfile
import zlib
from dataclasses import dataclass

import numpy as np

from .state import at_rest_dtype, narrow_arrays, widen_arrays

# snapshots retained per store; SHADOW_TPU_CHECKPOINT_KEEP overrides
DEFAULT_KEEP = 3

POINTER_FORMAT = "shadow_tpu.checkpoint.latest"


def named_leaves(hosts) -> list:
    """[(field_name, tensor)] in declaration order: the order the digest
    recorder hashes in."""
    return [(f.name, getattr(hosts, f.name))
            for f in dataclasses.fields(hosts)]


def flatten_order(hosts) -> list:
    """The field names in the order snapshots store them as leafN: the
    reference's pytree flatten order, which sorts the field names."""
    return sorted(f.name for f in dataclasses.fields(hosts))


# EngineConfig knobs that only schedule the reference's work, never
# what it computes: the fingerprint leaves them out.
_PERF_ONLY_KNOBS = ("active_block", "exsortcap", "dstcap",
                    "event_batch", "hot_split")


def scenario_fingerprint(scenario, cfg, seed: int) -> str:
    """Stable hash binding a checkpoint to its scenario and engine
    shape (the reference's: same repr, same config fields)."""
    cfg_sem = {k: v for k, v in sorted(
        dataclasses.asdict(cfg).items()) if k not in _PERF_ONLY_KNOBS}
    text = json.dumps({
        "scenario": repr(scenario),
        "cfg": json.dumps(cfg_sem, sort_keys=True, default=repr),
        "seed": seed,
    }, sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def base_of(path: str) -> str:
    """``run/ck.npz`` and ``run/ck`` both name the store whose
    snapshots are ``run/ck.w<windows>.npz``."""
    return path[:-4] if path.endswith(".npz") else path


# run ids usable as a store namespace: path-safe, no separators, no
# traversal (the fleet queue's run ids)
_RUN_ID_OK = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,99}$")


def valid_run_id(run_id: str) -> bool:
    return bool(_RUN_ID_OK.match(run_id or ""))


def run_store_base(root: str, run_id: str, name: str = "ck") -> str:
    """The store base ``<root>/<run_id>/<name>`` of one run of a fleet,
    so concurrent runs' snapshots, pointers and crash logs never
    collide; a run id that is not path-safe raises."""
    if not valid_run_id(run_id):
        raise ValueError(
            f"run id {run_id!r} is not a valid store namespace "
            "(want: letters/digits/._- only, starting with an "
            "alphanumeric, <=100 chars)")
    return os.path.join(root, run_id, name)


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_dir(path: str):
    """Make a rename durable across a machine crash."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass            # some filesystems refuse directory fsync
    finally:
        os.close(fd)


def _write_atomic(path: str, data: bytes):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


@dataclass
class Snapshot:
    """One restored checkpoint (load())."""
    hosts: dict                 # field -> wide numpy array
    wstart: int
    wend: int
    windows: int
    fault_idx: int = -1         # fault schedule position (-1: none)
    digest_records: int = -1    # chain records written (-1: digest off)
    digest_chain: str = None    # running chain hash at that position
    hosted_blob: bytes = None   # hosting.runtime snapshot sidecar


class CheckpointStore:
    """Owns one checkpoint base: atomic rotating snapshots + pointer."""

    def __init__(self, path: str, keep: int = 0):
        self.base = base_of(path)
        self.keep = int(keep) or int(os.environ.get(
            "SHADOW_TPU_CHECKPOINT_KEEP", str(DEFAULT_KEEP)))
        self.keep = max(self.keep, 1)

    def save(self, hosts, wstart, wend, windows: int, fingerprint: str,
             fault_idx: int = -1, digest_records: int = -1,
             digest_chain: str = None, hosted_blob: bytes = None,
             narrow: bool = True) -> str:
        """Write one snapshot of `hosts` (a port Hosts; one device to
        host copy per field), narrow at rest unless `narrow` is False,
        with `hosted_blob` as its ``.hosted`` sidecar. The npz and its
        sidecars are durable before the npz is published; the
        ``latest`` pointer flips last."""
        os.makedirs(os.path.dirname(os.path.abspath(self.base)),
                    exist_ok=True)
        arrs = {name: t.cpu().numpy() for name, t in named_leaves(hosts)}
        if narrow:
            arrs = narrow_arrays(arrs)
        file = f"{self.base}.w{int(windows):010d}.npz"
        tmp = file + ".tmp"
        hosted_name = hosted_sha = None
        if hosted_blob is not None:
            hosted_name = os.path.basename(file) + ".hosted"
            hosted_sha = hashlib.sha256(hosted_blob).hexdigest()
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f,
                __fingerprint__=np.frombuffer(
                    fingerprint.encode(), dtype=np.uint8),
                __wstart__=np.int64(int(wstart)),
                __wend__=np.int64(int(wend)),
                __windows__=np.int64(windows),
                __fault_idx__=np.int64(fault_idx),
                __digest_records__=np.int64(digest_records),
                __digest_chain__=np.frombuffer(
                    (digest_chain or "").encode(), dtype=np.uint8),
                # stamped inside the hash-verified npz, so _verify
                # demands a matching .hosted sidecar
                __hosted_sha__=np.frombuffer(
                    (hosted_sha or "").encode(), dtype=np.uint8),
                **{f"leaf{i}": arrs[name]
                   for i, name in enumerate(flatten_order(hosts))},
            )
            f.flush()
            os.fsync(f.fileno())
        sha = _sha256_file(tmp)
        _write_atomic(file + ".sha256", (sha + "\n").encode())
        if hosted_blob is not None:
            _write_atomic(file + ".hosted", hosted_blob)
        elif os.path.exists(file + ".hosted"):
            # a stale sidecar of an earlier hosted run of this base
            os.unlink(file + ".hosted")
        os.replace(tmp, file)
        _fsync_dir(os.path.dirname(os.path.abspath(file)))
        pointer = {
            "format": POINTER_FORMAT, "version": 1,
            "file": os.path.basename(file), "sha256": sha,
            "windows": int(windows), "wstart": int(wstart),
            "fingerprint": fingerprint,
            "hosted": hosted_name, "hosted_sha256": hosted_sha,
        }
        _write_atomic(self.pointer_path(),
                      (json.dumps(pointer, sort_keys=True) + "\n")
                      .encode())
        _fsync_dir(os.path.dirname(os.path.abspath(self.base)))
        self._prune(protect=file)
        return file

    def pointer_path(self) -> str:
        return self.base + ".latest"

    def _prune(self, protect: str):
        snaps = sorted(self.snapshots())
        for old in snaps[:-self.keep]:
            if old == protect:
                continue
            for suffix in ("", ".sha256", ".hosted"):
                try:
                    os.unlink(old + suffix)
                except OSError:
                    pass
        # stray temp files of killed saves
        for tmp in glob.glob(glob.escape(self.base) + ".w*.tmp"):
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def snapshots(self) -> list:
        """All on-disk snapshot .npz paths for this base."""
        return glob.glob(glob.escape(self.base) + ".w*.npz")


def _verify(path: str) -> bool:
    """The npz against its hash sidecar (none: trusted), then the
    hosted sidecar the npz stamps."""
    sidecar = path + ".sha256"
    try:
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                want = f.read().strip()
            if _sha256_file(path) != want:
                return False
    except OSError:
        return False
    try:
        with np.load(path) as z:
            hosted_sha = (bytes(z["__hosted_sha__"]).decode()
                          if "__hosted_sha__" in z else "")
    except Exception:
        return False        # unreadable/truncated npz
    if hosted_sha:
        try:
            with open(path + ".hosted", "rb") as f:
                got = hashlib.sha256(f.read()).hexdigest()
        except OSError:
            return False
        if got != hosted_sha:
            return False
    return True


def resolve_latest(path: str) -> str | None:
    """Newest snapshot of the store at `path` (a base, a base.npz or a
    pointer file) that verifies, or None. A corrupt head is reported
    and skipped."""
    base = base_of(path)
    candidates = []
    ptr = base + ".latest"
    if path.endswith(".latest"):
        ptr, base = path, path[:-len(".latest")]
    head = None
    if os.path.exists(ptr):
        try:
            with open(ptr) as f:
                meta = json.load(f)
            head = os.path.join(os.path.dirname(os.path.abspath(base)),
                                meta["file"])
        except (OSError, json.JSONDecodeError, KeyError):
            sys.stderr.write(
                f"shadow_tpu_torch: warning: checkpoint pointer {ptr} is "
                "unreadable; scanning for snapshots instead\n")
    if head is not None:
        candidates.append(head)
    seen = {os.path.abspath(c) for c in candidates}
    for snap in sorted(CheckpointStore(base).snapshots(), reverse=True):
        if os.path.abspath(snap) not in seen:
            candidates.append(snap)
    for cand in candidates:
        if not os.path.exists(cand):
            sys.stderr.write(
                f"shadow_tpu_torch: warning: checkpoint head {cand} is "
                "missing; falling back to an older snapshot\n")
            continue
        if not _verify(cand):
            sys.stderr.write(
                f"shadow_tpu_torch: WARNING: checkpoint {cand} fails "
                "verification (content hash mismatch, torn npz, or "
                "a missing/corrupt .hosted sidecar) — falling back "
                "to the previous snapshot\n")
            continue
        return cand
    return None


def load(path: str, hosts_template, fingerprint: str,
         strict: bool = True, narrow: bool = True) -> Snapshot:
    """Restore a snapshot -> Snapshot with wide numpy arrays. `path`
    is a .npz, a store base or a ``.latest`` pointer (resolved with
    corrupt-head fallback). `hosts_template` (a port Hosts) gives the
    shapes; `narrow` says whether this config stores narrow. The layout
    check is always a hard error; `strict=False` downgrades only the
    fingerprint check to a warning."""
    file = path
    if not (os.path.isfile(path) and path.endswith(".npz")):
        file = resolve_latest(path)
        if file is None:
            raise FileNotFoundError(
                f"no usable checkpoint under {path!r} (no snapshot "
                "written yet, or every candidate failed verification)")
    elif not _verify(file):
        raise ValueError(
            f"checkpoint {file} fails verification — the npz is "
            "unreadable or truncated or fails its content hash; resume "
            "from an older snapshot (pass the store base or 'latest' "
            "to fall back automatically)")
    names = flatten_order(hosts_template)
    try:
        with np.load(file) as z:
            got = bytes(z["__fingerprint__"]).decode()
            arrs = {name: z[f"leaf{i}"] for i, name in enumerate(names)}
            wstart = int(z["__wstart__"])
            wend = int(z["__wend__"])
            windows = int(z["__windows__"])
            fault_idx = (int(z["__fault_idx__"])
                         if "__fault_idx__" in z else -1)
            digest_records = (int(z["__digest_records__"])
                              if "__digest_records__" in z else -1)
            digest_chain = (bytes(z["__digest_chain__"]).decode()
                            if "__digest_chain__" in z else "") or None
    except (OSError, ValueError, KeyError, zipfile.BadZipFile,
            zlib.error) as e:
        raise ValueError(
            f"checkpoint {file} is unreadable or truncated "
            f"({type(e).__name__}: {e})") from e
    for i, name in enumerate(names):
        tpl = getattr(hosts_template, name)
        shape = tuple(tpl.shape)
        dt = at_rest_dtype(name, tpl[:0].cpu().numpy().dtype, narrow)
        new = arrs[name]
        if shape != new.shape or dt != new.dtype:
            raise ValueError(
                f"checkpoint layout mismatch at leaf {i}: snapshot "
                f"has {new.shape}/{new.dtype}, this scenario builds "
                f"{shape}/{dt} — the snapshot belongs to a "
                "different engine configuration")
    if got != fingerprint:
        if strict:
            raise ValueError(
                f"checkpoint fingerprint {got} does not match scenario "
                f"{fingerprint}: refusing to resume into a different "
                "simulation")
        sys.stderr.write(
            f"shadow_tpu_torch: warning: resuming past a checkpoint "
            f"fingerprint mismatch ({got} vs {fingerprint})\n")
    if narrow:
        arrs = widen_arrays(arrs)
    hosted_blob = None
    if os.path.exists(file + ".hosted"):
        with open(file + ".hosted", "rb") as f:
            hosted_blob = f.read()
    return Snapshot(hosts=arrs, wstart=wstart, wend=wend, windows=windows,
                    fault_idx=fault_idx, digest_records=digest_records,
                    digest_chain=digest_chain, hosted_blob=hosted_blob)
