"""The memory tier: one captured CUDA graph of the window chunk per signature.

Counterpart of ``shadow_tpu/core/jitcache.py`` (``AotJit``), which keeps
one compiled XLA executable per argument signature. The port's
counterpart of a compiled chunk is a CUDA graph of it, captured once
(:func:`capture`) and replayed for every chunk after. Its signature
(:func:`signature`) is the reference's cache scope
``run_windows.c<chunk>.<fp16>`` (the config fingerprint and the chunk),
the chunk's static plan (the constants the capture bakes in: the seed,
the dispatch codes the config can produce, the loop bounds) and each
state leaf's shape, dtype, device and ``data_ptr``: a graph reads and
writes the addresses it saw at capture, so rebinding a state tensor
changes the signature and causes a counted re-capture, never a stale
read. The stop time is not part of it: it is a static input, copied in
before each replay.

A graph's temporaries live in a memory pool of its own
(``torch.cuda.MemPool``), every body's at once; its size is recorded
(``pool_bytes``). A capture records no kernel run, so the chunk's lazily
built tables are built before it (``engine.window.prepare_capture``),
and capture runs in CUDA's relaxed mode, where lazy module loading may
happen; a host read inside the chunk still fails the capture, which
raises: nothing falls back to the eager loop.

:data:`STATS` keeps the reference's key names where they mean the same:
``compiles`` and ``compile_wall_s`` (captures and their wall), plus
``replays``, ``pool_bytes`` (the newest graph's) and ``nodes`` (its
conditional nodes). A capture records a ``jitcache.compile`` span, which
``obs.perf`` attributes to the reference's ``compile-miss`` phase. The
native library's disk tier is ``serving.aotcache``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time
from collections import OrderedDict

import torch

from . import flow as FL

STATS = {"compiles": 0, "compile_wall_s": 0.0, "replays": 0,
         "pool_bytes": 0, "nodes": 0}

# graphs kept in memory (least recently used dropped past this): each
# holds a memory pool
KEEP = 4


def _fp(cfg) -> str:
    from ..obs.ledger import ENGINE, fingerprint_of
    return fingerprint_of(cfg, engine=ENGINE)


def cache_scope(cfg, chunk: int) -> str:
    """The reference's scope string, ``run_windows.c<chunk>.<fp16>``
    (the fingerprint ``--shape-fingerprint`` prints)."""
    return f"run_windows.c{int(chunk)}.{_fp(cfg)}"


def batch_scope(cfg, chunk: int, lanes: int) -> str:
    """The reference's scope of the batched chunk,
    ``run_windows_batch.c<chunk>.b<lanes>.<fp16>``."""
    return f"run_windows_batch.c{int(chunk)}.b{int(lanes)}.{_fp(cfg)}"


def sharded_scope(cfg, chunk: int, mesh) -> str:
    """The reference's scope of the sharded chunk, which pins the mesh's
    devices: ``run_windows_sharded.c<chunk>.s<shards>.d<ids>.<fp16>``
    (`cfg` the padded global config)."""
    devs = "-".join(str(d.index if d.index is not None else d.type)
                    for d in mesh)
    return (f"run_windows_sharded.c{int(chunk)}.s{mesh.size}.d{devs}"
            f".{_fp(cfg)}")


def leaf_sig(trees, skip=("stop_time",)) -> tuple:
    """(name, shape, dtype, device, data_ptr) of every tensor field of
    the dataclasses `trees` (and of the tensors of a dict field), bar
    the names in `skip`."""
    out = []
    for i, tr in enumerate(trees):
        for f in dataclasses.fields(tr):
            v = getattr(tr, f.name)
            if f.name in skip:
                continue
            items = (sorted(v.items()) if isinstance(v, dict)
                     else [("", v)])
            for k, t in items:
                if torch.is_tensor(t):
                    out.append((i, f.name + k, tuple(t.shape),
                                str(t.dtype), str(t.device), t.data_ptr()))
    return tuple(out)


def signature(scope: str, plan, trees) -> tuple:
    return (scope, plan, leaf_sig(trees))


class Graph:
    """One captured, instantiated graph with its memory pool and the
    tensors it reads (`keep`, alive as long as it is)."""

    def __init__(self, graph, exec_, pool, keep, nodes: dict,
                 pool_bytes: int, wall: float, device):
        self._graph, self._exec = graph, exec_
        self.pool, self.keep = pool, keep
        self.nodes, self.pool_bytes, self.wall = nodes, pool_bytes, wall
        self.device = device

    def replay(self):
        """Launch the graph on its card's current stream."""
        from . import kernels
        with torch.cuda.device(self.device):
            kernels.check(kernels.lib().sf_launch(
                self._exec,
                torch.cuda.current_stream(self.device).cuda_stream),
                "graph launch")
        STATS["replays"] += 1

    def close(self):
        if self._exec is not None or self._graph is not None:
            from . import kernels
            torch.cuda.synchronize(self.device)
            kernels.check(kernels.lib().sf_destroy(self._graph, self._exec),
                          "graph destroy")
            self._graph = self._exec = None
        self.keep = self.pool = None


def capture(fn, device, keep=()) -> Graph:
    """Capture ``fn()`` — written against ``core.flow`` — into a CUDA
    graph on `device`, under a :class:`~core.flow.GraphFlow`, without
    running it. Raises on any failure (the capture is abandoned)."""
    from . import kernels
    from ..obs import metrics as MT
    from ..obs import trace as TR
    lib = kernels.lib()
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    t0 = TR.TRACER.now() if TR.ENABLED else None
    w0 = time.perf_counter()
    torch.cuda.synchronize(device)
    r0 = torch.cuda.memory_reserved(device)
    pool = torch.cuda.MemPool()
    flow = FL.GraphFlow(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    g = ctypes.c_void_p()
    with torch.cuda.use_mem_pool(pool, device), torch.cuda.stream(side):
        kernels.check(lib.sf_capture_begin(side.cuda_stream),
                      "capture begin")
        try:
            with FL.using(flow):
                fn()
        except BaseException:
            lib.sf_capture_end(side.cuda_stream, ctypes.byref(g))
            if g.value:
                lib.sf_destroy(g, None)
            raise
        kernels.check(lib.sf_capture_end(side.cuda_stream, ctypes.byref(g)),
                      "capture end")
    x = ctypes.c_void_p()
    rc = lib.sf_instantiate(g, ctypes.byref(x))
    if rc:
        lib.sf_destroy(g, None)
        kernels.check(rc, "graph instantiate")
    torch.cuda.current_stream(device).wait_stream(side)
    pool_bytes = torch.cuda.memory_reserved(device) - r0
    wall = time.perf_counter() - w0
    STATS["compiles"] += 1
    STATS["compile_wall_s"] += wall
    STATS["pool_bytes"] = pool_bytes
    STATS["nodes"] = sum(flow.nodes.values())
    if TR.ENABLED:
        TR.TRACER.complete("jitcache.compile", t0,
                           args={"nodes": STATS["nodes"],
                                 "pool_bytes": pool_bytes})
    if MT.ENABLED:
        MT.REGISTRY.counter("jitcache.compiles").inc()
        gg = MT.REGISTRY.gauge("jitcache.compile_wall_s")
        gg.set(gg.v + wall)
    return Graph(g, x, pool, tuple(keep), dict(flow.nodes), pool_bytes,
                 wall, device)


class ChunkCache:
    """Captured graphs by signature, the least recently used dropped
    past :data:`KEEP`."""

    def __init__(self):
        self._graphs = OrderedDict()
        self.last = None

    def warm(self, sig, build) -> Graph:
        """The graph for `sig`, captured by ``build()`` on a miss, not
        replayed (the reference's ``AotJit.warm``)."""
        g = self._graphs.get(sig)
        if g is None:
            g = build()
            self._graphs[sig] = g
            while len(self._graphs) > KEEP:
                _, old = self._graphs.popitem(last=False)
                old.close()
        else:
            self._graphs.move_to_end(sig)
        self.last = g
        return g


CHUNKS = ChunkCache()


def last_graph():
    """The graph most recently captured or looked up (None before)."""
    return CHUNKS.last
