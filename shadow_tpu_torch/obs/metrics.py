"""Metrics registry: counters, gauges and histograms with JSON export.

Counterpart of ``shadow_tpu/obs/metrics.py``, with its snapshot layout:
one registry that the CLI, the tracker, the pcap writer and the run
loop all publish into.

- counters   monotonically increasing counts (windows run, tracker
  lines, pcap records, digest records);
- gauges     last-value samples (sim time, summary figures);
- histograms value distributions with fixed bucket bounds.

``Registry.chunk(**fields)`` appends one JSON line per window chunk to
``<metrics>.chunks.jsonl`` (streamed, so a crashed run keeps its
lines); ``Registry.snapshot()`` is the final ``metrics.json``, shaped
to diff against the ``BENCH_*.json`` rounds: ``sim`` holds
``SimReport.summary()``, ``net`` the network observatory, ``perf`` the
phase attribution, ``memory`` the watermark and, in hosted runs,
``shim`` the LD_PRELOAD shim's per-op counts and latencies.

Cheap when disabled: ``ENABLED`` is a module boolean the hot paths
check, as in ``obs.trace``.
"""

from __future__ import annotations

import json
import os
from bisect import bisect_left

ENABLED = False
REGISTRY = None

# default histogram bounds: a log-ish µs ladder from 1 µs to 10 s
DEFAULT_BOUNDS = (1, 2, 5, 10, 20, 50, 100, 200, 500,
                  1_000, 2_000, 5_000, 10_000, 50_000, 100_000,
                  1_000_000, 10_000_000)


class Counter:
    __slots__ = ("n",)

    def __init__(self):
        self.n = 0

    def inc(self, k: int = 1):
        self.n += k


class Gauge:
    __slots__ = ("v",)

    def __init__(self):
        self.v = 0.0

    def set(self, v):
        self.v = v


class Histogram:
    """Fixed-bound histogram: observe() bisects into len(bounds)+1
    buckets (the last is the overflow bucket)."""

    __slots__ = ("bounds", "buckets", "count", "total", "vmin", "vmax")

    def __init__(self, bounds=DEFAULT_BOUNDS):
        self.bounds = tuple(bounds)
        self.buckets = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None

    def observe(self, v):
        self.buckets[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.total += v
        if self.vmin is None or v < self.vmin:
            self.vmin = v
        if self.vmax is None or v > self.vmax:
            self.vmax = v

    def snapshot(self) -> dict:
        out = {"count": self.count, "sum": self.total,
               "min": self.vmin, "max": self.vmax,
               "mean": (self.total / self.count) if self.count else None,
               "buckets": {}}
        for le, n in zip(self.bounds, self.buckets):
            if n:
                out["buckets"][f"le_{le}"] = n
        if self.buckets[-1]:
            out["buckets"]["overflow"] = self.buckets[-1]
        return out


class Registry:
    """Get-or-create metric store + export. `path` is the final
    snapshot file, `jsonl_path` the per-chunk line stream; either may
    be None (collect in memory only)."""

    def __init__(self, path: str = None, jsonl_path: str = None):
        self.path = path
        self.jsonl_path = jsonl_path
        self._jsonl = None           # opened on first chunk line
        self.counters = {}
        self.gauges = {}
        self.histograms = {}
        self.chunks = []             # retained per-chunk lines (tests)

    # --- get-or-create accessors (hot path: one dict hit) ---
    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str, bounds=DEFAULT_BOUNDS) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(bounds)
        return h

    # --- export ---
    def publish(self, prefix: str, mapping: dict):
        """Expose every numeric value of `mapping` as a gauge named
        ``<prefix>.<key>`` — how SimReport.summary() becomes the
        registry's ``sim`` section (one source of truth for the CLI,
        tracker and bench)."""
        for k, v in mapping.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            self.gauge(f"{prefix}.{k}").set(v)

    def chunk(self, **fields):
        """One per-window-chunk JSON line (engine.sim's chunk loop)."""
        self.chunks.append(fields)
        if self.jsonl_path is not None:
            if self._jsonl is None:
                self._jsonl = open(self.jsonl_path, "w")
            self._jsonl.write(json.dumps(fields) + "\n")
            self._jsonl.flush()

    def snapshot(self) -> dict:
        counters = {k: c.n for k, c in sorted(self.counters.items())}
        gauges = {k: g.v for k, g in sorted(self.gauges.items())}
        hists = {k: h.snapshot()
                 for k, h in sorted(self.histograms.items())}

        def section(prefix):
            # a gauge family as a section; ``<name>.<i>`` families fold
            # into per-index lists
            return _assemble_indexed({k[len(prefix):]: v
                                      for k, v in gauges.items()
                                      if k.startswith(prefix)})

        out = {"sim": section("sim."), "counters": counters,
               "gauges": gauges, "histograms": hists,
               "chunks": len(self.chunks)}
        # the phase attribution (obs.perf), the memory watermark
        # (obs.memscope), the netscope read-outs and a mesh run's
        # per-shard load (events, active hosts and passes per shard, the
        # imbalance), when published
        for name, prefix in (("perf", "perf."), ("memory", "mem."),
                             ("net", "net."), ("shards", "shard.")):
            sec = section(prefix)
            if sec:
                out[name] = sec
        # the LD_PRELOAD shim's per-op counts and handler latencies and
        # its supervision counters (hosting.shim), in hosted runs
        ops = {k[len("shim.op."):]: v for k, v in counters.items()
               if k.startswith("shim.op.")}
        superv = {k[len("shim."):]: v for k, v in counters.items()
                  if k in ("shim.child_exits", "shim.supervisor_kills",
                           "shim.violations")}
        if ops or superv:
            out["shim"] = {
                "ops": ops,
                "op_latency_us": {k[len("shim.op_us."):]: v
                                  for k, v in hists.items()
                                  if k.startswith("shim.op_us.")}}
            if superv:
                out["shim"]["supervision"] = superv
        return out

    def close(self):
        """Write the final snapshot (if a path was given) and release
        the chunk stream."""
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self.path is not None:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.snapshot(), f, indent=1)
            os.replace(tmp, self.path)


def _assemble_indexed(flat: dict) -> dict:
    """Fold ``<name>.<int>`` gauge families into per-index lists:
    ``{"events.0": 5, "events.1": 7, "imbalance": 1.2}`` becomes
    ``{"events": [5, 7], "imbalance": 1.2}`` — how the netscope
    ``<kind>.bucket.<i>`` gauges become bucket lists. Missing indices
    read as None (an empty bucket)."""
    series, scalars = {}, {}
    for k, v in flat.items():
        base, _, idx = k.rpartition(".")
        if base and idx.isdigit():
            series.setdefault(base, {})[int(idx)] = v
        else:
            scalars[k] = v
    out = dict(scalars)
    for base, vals in series.items():
        n = max(vals) + 1
        out[base] = [vals.get(i) for i in range(n)]
    return out


def install(path: str = None, jsonl_path: str = None) -> Registry:
    """Enable metrics process-wide; the installer owns finish()."""
    global ENABLED, REGISTRY
    REGISTRY = Registry(path=path, jsonl_path=jsonl_path)
    ENABLED = True
    return REGISTRY


def finish() -> Registry | None:
    """Disable metrics, write the snapshot, return the registry."""
    global ENABLED, REGISTRY
    reg, REGISTRY, ENABLED = REGISTRY, None, False
    if reg is not None:
        reg.close()
    return reg



def shim_op(op_name: str, dt_ns: int):
    """One served shim request (hosting.shim): its count and its
    handler latency in microseconds."""
    r = REGISTRY
    r.counter("shim.op." + op_name).inc()
    r.histogram("shim.op_us." + op_name).observe(dt_ns / 1000.0)
