"""The disk tier of the port's compiled code: the nvcc-built library.

Counterpart of ``shadow_tpu/serving/aotcache.py``. The reference stores
serialized XLA executables so that a fresh process loads a known
program instead of compiling it. The port's compiled program is a
captured CUDA graph of the window chunk (``core.jitcache``), and a CUDA
graph cannot outlive its process: every process captures its own. What
a fresh process can load instead of building is the port's native code,
the library that ``core.kernels`` builds with nvcc from
``shadow_tpu_torch/csrc`` (the chunk's kernels and the conditional-node
capture helpers). This module keeps it on disk.

Key anatomy — an entry loads only when all of these match, so a stale
library is unreachable, never loaded and wrong:

- the scope (which library) and its build signature (target, flags);
- a source digest over the ``.cu``/``.cpp``/``.c`` files it builds
  from: an edit invalidates every entry, with no version to bump;
- the toolchain: the nvcc version, ``torch.__version__`` and
  ``torch.version.cuda``;
- the device: its name and compute capability.

Storage is crash-safe, as the reference keeps it: the ``.sha256`` and
``.meta.json`` sidecars publish before the payload's tmp + fsync +
``os.replace``, loads verify the hash and rebuild loudly on a torn,
corrupt or alien entry (which is removed), publishing is
first-writer-wins under a per-key lock, and retention keeps the newest
:data:`DEFAULT_KEEP` entries (``SHADOW_TPU_TORCH_AOT_CACHE_KEEP``).

Without ``--aot-cache DIR`` or ``SHADOW_TPU_TORCH_AOT_CACHE`` the
library still builds once per checkout, into ``build/kernels`` (listed
in ``.gitignore``; created owner-only, like ``hosting/build.py``'s
directory), so a plain run builds at first use and loads afterwards.

:data:`STATS` counts, in every process: ``builds`` and
``build_wall_s`` (nvcc runs), ``disk_hits``, ``disk_misses``,
``disk_stores``, ``rejected`` and ``load_wall_s``. A build records a
``jitcache.compile`` span and a load a ``jitcache.load`` span, which
``obs.perf`` attributes to the ``compile-miss`` and ``compile-hit``
phases; the ``jitcache.*`` metrics mirror the counts when the registry
is on.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

FORMAT = "shadow_tpu_torch.serving.aotcache"
VERSION = 1

ENV = "SHADOW_TPU_TORCH_AOT_CACHE"
KEEP_ENV = "SHADOW_TPU_TORCH_AOT_CACHE_KEEP"
DEFAULT_KEEP = 64

STATS = {"builds": 0, "build_wall_s": 0.0, "disk_hits": 0,
         "disk_misses": 0, "disk_stores": 0, "rejected": 0,
         "load_wall_s": 0.0}

ACTIVE = None
_ENV_CHECKED = False

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
SOURCE_DIR = os.path.join(_PKG, "csrc")
SOURCE_EXT = (".cu", ".cuh", ".cpp", ".c", ".h")
SUFFIX = ".so"


def _warn(msg: str):
    sys.stderr.write(f"shadow_tpu_torch: aot-cache: {msg}\n")


def install(root: str, keep: int = None) -> "DiskCache":
    """Use `root` as the disk tier for this process."""
    global ACTIVE
    ACTIVE = DiskCache(root, keep=keep)
    return ACTIVE


def uninstall():
    global ACTIVE, _ENV_CHECKED
    ACTIVE = None
    _ENV_CHECKED = True      # tests: do not fall back to the variable


def active() -> "DiskCache | None":
    """The installed cache, resolving SHADOW_TPU_TORCH_AOT_CACHE once a
    process, so fleet children take the tier without CLI plumbing."""
    global _ENV_CHECKED
    if ACTIVE is None and not _ENV_CHECKED:
        _ENV_CHECKED = True
        env = os.environ.get(ENV)
        if env:
            install(env)
    return ACTIVE


def default_dir() -> str:
    """``build/kernels`` at the root of the checkout, owner-only."""
    d = os.path.join(_ROOT, "build", "kernels")
    os.makedirs(d, mode=0o700, exist_ok=True)
    return d


def cache() -> "DiskCache":
    """The active cache, else the checkout's default directory."""
    return active() or DiskCache(default_dir())


# --- key components ---------------------------------------------------------

def source_digest(root: str = SOURCE_DIR) -> str:
    """sha256 over the native sources under `root` (sorted relative
    paths, name and content)."""
    h = hashlib.sha256()
    files = []
    for dirpath, _, names in os.walk(root):
        for n in names:
            if n.endswith(SOURCE_EXT):
                p = os.path.join(dirpath, n)
                files.append((os.path.relpath(p, root), p))
    for rel, p in sorted(files):
        h.update(rel.encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    """``$NVCC``, else nvcc on the PATH, else the toolkit's."""
    import shutil
    return (os.environ.get("NVCC") or shutil.which("nvcc")
            or "/usr/local/cuda/bin/nvcc")


_NVCC_VERSION = None


def nvcc_version() -> str:
    """The last line of ``nvcc --version`` ("none" without nvcc)."""
    global _NVCC_VERSION
    if _NVCC_VERSION is None:
        try:
            out = subprocess.run([nvcc_path(), "--version"],
                                 capture_output=True, text=True).stdout
            lines = out.strip().splitlines()
            _NVCC_VERSION = lines[-1] if lines else "none"
        except OSError:
            _NVCC_VERSION = "none"
    return _NVCC_VERSION


def platform_key() -> dict:
    """The toolchain and device components of the key."""
    import torch
    if torch.cuda.is_available():
        cc = torch.cuda.get_device_capability(0)
        dev, cap = torch.cuda.get_device_name(0), f"{cc[0]}.{cc[1]}"
    else:
        dev, cap = "cpu", "none"
    return {"nvcc": nvcc_version(), "torch": torch.__version__,
            "torch_cuda": torch.version.cuda or "none",
            "device": dev, "capability": cap}


def key_meta(scope: str, sig, platform: dict = None,
             source: str = None) -> dict:
    return {"format": FORMAT, "version": VERSION, "scope": scope,
            "sig": json.dumps(sig, sort_keys=True),
            "platform": platform if platform is not None else platform_key(),
            "source": source if source is not None else source_digest()}


def entry_key(scope: str, sig, platform: dict = None,
              source: str = None) -> str:
    """One disk entry's key from all of its components; the
    ``.meta.json`` sidecar records them for post-mortems."""
    blob = json.dumps(key_meta(scope, sig, platform, source),
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


# --- the disk tier ----------------------------------------------------------

def _write_atomic(path: str, data: bytes):
    """tmp + fsync + os.replace: a crash mid-write never publishes a
    torn file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class DiskCache:
    """One directory of built libraries."""

    # a publisher holding a key's lock longer than this is presumed
    # dead (killed mid-store) and its lock is broken
    LOCK_STALE_S = 600.0

    def __init__(self, root: str, keep: int = None):
        self.root = root
        if keep is None:
            keep = int(os.environ.get(KEEP_ENV, str(DEFAULT_KEEP)))
        self.keep = max(int(keep), 1)

    def path(self, key: str) -> str:
        return os.path.join(self.root, key + SUFFIX)

    def meta_path(self, key: str) -> str:
        return os.path.join(self.root, key + ".meta.json")

    def has(self, key: str) -> bool:
        return os.path.exists(self.path(key))

    def entries(self) -> list:
        """Stored keys, oldest mtime first."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        paths = [os.path.join(self.root, n) for n in names
                 if n.endswith(SUFFIX)]

        def mtime(p):
            try:
                return os.path.getmtime(p)
            except OSError:
                return 0.0
        return [os.path.basename(p)[:-len(SUFFIX)]
                for p in sorted(paths, key=lambda p: (mtime(p), p))]

    def load(self, key: str, meta: dict = None) -> str | None:
        """-> the verified entry's path, or None (a miss). A missing or
        mismatched hash, or a meta sidecar that names another key
        anatomy (an alien entry), is rejected loudly and removed."""
        p = self.path(key)
        try:
            with open(p, "rb") as f:
                blob = f.read()
        except OSError:
            STATS["disk_misses"] += 1
            return None
        try:
            with open(p + ".sha256") as f:
                want = f.read().strip()
        except OSError:
            want = None
        if want is None or hashlib.sha256(blob).hexdigest() != want:
            self._reject(key, "content hash missing or mismatched "
                         "(torn write / bit rot)")
            return None
        if meta is not None:
            try:
                with open(self.meta_path(key)) as f:
                    got = json.load(f)
            except (OSError, ValueError):
                got = None
            if got is None or any(got.get(k) != v for k, v in meta.items()):
                self._reject(key, "meta sidecar missing or naming another "
                             "key anatomy (alien entry)")
                return None
        return p

    def _reject(self, key: str, why: str):
        STATS["rejected"] += 1
        _warn(f"entry {key}: {why} — rebuilding and dropping the entry")
        self.remove(key)

    def remove(self, key: str):
        for p in (self.path(key), self.path(key) + ".sha256",
                  self.meta_path(key)):
            try:
                os.unlink(p)
            except OSError:
                pass

    def _publish_lock(self, key: str):
        """O_EXCL per-key writer lock -> (fd, path), or None while
        another live writer publishes this key (first writer wins)."""
        lock = self.path(key) + ".lock"
        for _ in range(2):
            try:
                return os.open(lock, os.O_CREAT | os.O_EXCL
                               | os.O_WRONLY), lock
            except FileExistsError:
                try:
                    if (time.time() - os.path.getmtime(lock)
                            < self.LOCK_STALE_S):
                        return None
                    os.unlink(lock)        # stale: a dead writer
                except OSError:
                    return None
        return None

    def store(self, key: str, blob: bytes, meta: dict = None) -> str | None:
        """Publish one entry -> its path, or None when a complete entry
        is already there or another writer holds the key. Sidecars
        publish before the payload, so a visible payload always has its
        hash."""
        os.makedirs(self.root, mode=0o700, exist_ok=True)
        if self.has(key):
            return None
        got = self._publish_lock(key)
        if got is None:
            return None
        fd, lock = got
        try:
            if self.has(key):
                return None
            p = self.path(key)
            _write_atomic(p + ".sha256",
                          (hashlib.sha256(blob).hexdigest()
                           + "\n").encode())
            m = dict(meta or {})
            m["payload_bytes"] = len(blob)
            _write_atomic(self.meta_path(key),
                          (json.dumps(m, indent=1, sort_keys=True)
                           + "\n").encode())
            _write_atomic(p, blob)
            os.chmod(p, 0o700)
            STATS["disk_stores"] += 1
            self._retain()
            return p
        finally:
            os.close(fd)
            try:
                os.unlink(lock)
            except OSError:
                pass

    def _retain(self):
        keys = self.entries()
        for key in keys[:max(len(keys) - self.keep, 0)]:
            self.remove(key)


# --- the build-or-load path -------------------------------------------------

def load_or_build(scope: str, sig, build, platform: dict = None,
                  source: str = None, store: "DiskCache" = None) -> str:
    """The path of the library `scope` built with signature `sig`:
    loaded from the disk tier when a verified entry is there, else
    built by ``build(out_path)`` (which raises on failure, with the
    compiler's output) and published. `platform` and `source` default
    to this process's :func:`platform_key` and :func:`source_digest`;
    `store` to :func:`cache`."""
    from ..obs import metrics as MT
    from ..obs import trace as TR

    dc = store or cache()
    meta = key_meta(scope, sig, platform, source)
    key = entry_key(scope, sig, meta["platform"], meta["source"])
    t0 = TR.TRACER.now() if TR.ENABLED else None
    w0 = time.perf_counter()
    path = dc.load(key, meta)
    if path is not None:
        wall = time.perf_counter() - w0
        STATS["disk_hits"] += 1
        STATS["load_wall_s"] += wall
        if TR.ENABLED:
            TR.TRACER.complete("jitcache.load", t0,
                               args={"key": key, "scope": scope})
        if MT.ENABLED:
            MT.REGISTRY.counter("jitcache.disk_hits").inc()
            g = MT.REGISTRY.gauge("jitcache.load_wall_s")
            g.set(g.v + wall)
        return path
    t0 = TR.TRACER.now() if TR.ENABLED else None
    w0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=dc.root if os.path.isdir(dc.root)
                                     else None) as tmp:
        out = os.path.join(tmp, scope + SUFFIX)
        build(out)
        with open(out, "rb") as f:
            blob = f.read()
        wall = time.perf_counter() - w0
        STATS["builds"] += 1
        STATS["build_wall_s"] += wall
        if TR.ENABLED:
            TR.TRACER.complete("jitcache.compile", t0,
                               args={"scope": scope, "cached": True})
        if MT.ENABLED:
            MT.REGISTRY.counter("jitcache.builds").inc()
            g = MT.REGISTRY.gauge("jitcache.build_wall_s")
            g.set(g.v + wall)
        dc.store(key, blob, meta=meta)
        if dc.has(key):
            got = dc.load(key, meta)
            if got is not None:
                return got
        # another writer holds the key: keep a private copy
        own = os.path.join(dc.root, f"{key}.{os.getpid()}.own")
        _write_atomic(own, blob)
        return own
