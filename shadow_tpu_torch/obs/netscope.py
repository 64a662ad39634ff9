"""Network observatory: per-host latency histograms on the device, a
per-chunk network time-series stream, and ensemble percentile curves.

Counterpart of ``shadow_tpu/obs/netscope.py``, with the same wire
format:

1. **Histograms on the device** — ``Hosts.ns_hist`` ([H, NS_KINDS,
   NS_BUCKETS] i64) counts samples into power-of-two microsecond
   buckets at the measurement sites (the ST_RTT_SUM_US updates, app
   completions, NIC queue admission, TCP retransmission). With
   ``EngineConfig.netscope`` off the bucket axis has zero width, and
   :func:`observe` returns before it issues any tensor operation; call
   sites that must compute a sample's value first test :func:`on`.
2. **Per-chunk time-series** — :class:`NetScope` samples stat totals,
   deltas, active connections and histogram deltas at every chunk
   boundary into a JSONL stream. Every value derives from device state
   and sim time, so same-seed runs, on either package, give
   byte-identical streams.
3. **Ensembles** — :func:`fold`/:func:`ensemble` reduce any nesting of
   per-run tables to pooled percentiles, per-run tails and a CDF.

Bucket 0 holds values < 1 µs, bucket i (1..30) holds [2^(i-1), 2^i)
µs, bucket 31 is the overflow (>= 2^30 µs). Bucketing is a count of
integer bounds, so the card, the CPU and the reference agree.
"""

from __future__ import annotations

import json

import torch

# kind indices into the ns_hist kind axis (the wire order of the JSONL
# `hist` tables and of the metrics `net` section)
NS_RTT = 0         # round-trip / one-way propagation time (µs)
NS_COMPLETION = 1  # client-observed transfer/fetch completion (µs)
NS_QUEUE = 2       # NIC rx-queue delay at admit (µs)
NS_RETX = 3        # RTO in force at each retransmission (µs)
NS_KINDS = 4
NS_BUCKETS = 32
KIND_NAMES = ("rtt", "completion", "queue", "retx")

# value v lands in bucket sum(v >= BOUNDS_US): 31 bounds, 32 buckets
BOUNDS_US = tuple(1 << k for k in range(NS_BUCKETS - 1))

FORMAT = "shadow_tpu.netscope.v1"

_BOUNDS = {}        # device -> the BOUNDS_US tensor


def on(st) -> bool:
    """Whether this state carries the histograms (netscope on)."""
    return st.ns_hist.shape[2] != 0


def bounds(device):
    """The BOUNDS_US tensor on `device` (made at first use)."""
    b = _BOUNDS.get(device)
    if b is None:
        b = _BOUNDS[device] = torch.tensor(BOUNDS_US, dtype=torch.int64,
                                           device=device)
    return b


def observe(st, m, kind: int, value_us):
    """Count one sample per row into ``st.ns_hist[:, kind]`` where the
    [H] mask `m` holds; `value_us` is an [H] integer tensor of
    microseconds. Integer adds only. With netscope off (zero bucket
    width) this returns before any tensor operation."""
    h = st.ns_hist
    if h.shape[2] == 0:
        return
    b = bounds(h.device)
    idx = (value_us.to(torch.int64)[:, None] >= b).sum(1, keepdim=True)
    h[:, kind].scatter_add_(1, idx, m.to(torch.int64)[:, None])


def bucket_of(value_us: int) -> int:
    """Host-side mirror of the device bucketing."""
    v = int(value_us)
    if v <= 0:
        return 0
    return min(v.bit_length(), NS_BUCKETS - 1)


def bucket_edge_us(i: int) -> int:
    """Upper edge of bucket i in µs (the overflow bucket reports the
    saturated edge 2^31)."""
    return 1 << min(int(i), NS_BUCKETS - 1)


def _tolist(h):
    return h.tolist() if hasattr(h, "tolist") else h


def _add(a, b):
    if isinstance(a, list):
        return [_add(x, y) for x, y in zip(a, b)]
    return a + b


def fold(hist):
    """Sum any leading axes of a histogram down to one
    [NS_KINDS][NS_BUCKETS] table of ints: [K][B], [H][K][B], [N][K][B]
    or [L][H][K][B]; numpy arrays, tensors and nested lists alike."""
    h = _tolist(hist)
    if not h or not h[0]:
        return []
    while h[0] and isinstance(h[0][0], list):
        acc = h[0]
        for t in h[1:]:
            acc = _add(acc, t)
        h = acc
    return [[int(c) for c in r] for r in h]


def percentile(counts, q: int) -> int:
    """Exact percentile of one bucket row: the upper edge (µs) of the
    smallest bucket whose cumulative count reaches ceil(q/100 · N); 0
    for an empty row."""
    counts = [int(c) for c in counts]
    n = sum(counts)
    if n <= 0:
        return 0
    rank = max(1, -((-n * q) // 100))
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        if acc >= rank:
            return 1 << i
    return 1 << (NS_BUCKETS - 1)


def kind_summary(counts) -> dict:
    """One kind's headline figures and raw buckets."""
    counts = [int(c) for c in counts]
    return {
        "count": sum(counts),
        "p50_us": percentile(counts, 50),
        "p90_us": percentile(counts, 90),
        "p99_us": percentile(counts, 99),
        "buckets": counts,
    }


def report(hist) -> dict:
    """SimReport.network payload from a final histogram."""
    table = fold(hist)
    if not table:
        return {}
    return {
        "bounds_us": list(BOUNDS_US),
        "kinds": {name: kind_summary(table[k])
                  for k, name in enumerate(KIND_NAMES)},
    }


def ensemble(tables) -> dict:
    """Cross-run percentile curves: the pooled distribution and per-run
    tails per kind. `tables` lists per-run histograms."""
    tables = [fold(t) for t in tables]
    tables = [t for t in tables if t]
    if not tables:
        return {}
    pooled = fold(tables)
    out = {"runs": len(tables), "bounds_us": list(BOUNDS_US),
           "kinds": {}}
    for k, name in enumerate(KIND_NAMES):
        tot = sum(pooled[k])
        cum, cdf = 0, []
        for c in pooled[k]:
            cum += c
            cdf.append(round(cum / tot, 6) if tot else 0.0)
        out["kinds"][name] = {
            "count": tot,
            "p50_us": percentile(pooled[k], 50),
            "p90_us": percentile(pooled[k], 90),
            "p99_us": percentile(pooled[k], 99),
            "lane_p50_us": [percentile(t[k], 50) for t in tables],
            "lane_p99_us": [percentile(t[k], 99) for t in tables],
            "cdf": cdf,
            "buckets": pooled[k],
        }
    return out


class NetScope:
    """Per-chunk network time-series recorder: records in memory
    (``.records``) and, given a path, as compact sorted-key JSON lines
    after a self-describing header line."""

    def __init__(self, path: str | None = None):
        from ..engine import defs as _d
        self._stat_cols = (
            ("events", _d.ST_EVENTS),
            ("pkts_sent", _d.ST_PKTS_SENT),
            ("pkts_recv", _d.ST_PKTS_RECV),
            ("bytes_sent", _d.ST_BYTES_SENT),
            ("bytes_recv", _d.ST_BYTES_RECV),
            ("retransmits", _d.ST_RETRANSMIT),
            ("drop_net", _d.ST_PKTS_DROP_NET),
            ("drop_buf", _d.ST_PKTS_DROP_BUF),
            ("xfers_done", _d.ST_XFER_DONE),
        )
        self.path = path
        self.records = []
        self._prev_tot = None
        self._prev_hist = None
        self._last_table = None
        self._fh = None
        if self.path:
            self._fh = open(self.path, "w")
            self._write({"format": FORMAT, "kinds": list(KIND_NAMES),
                         "bounds_us": list(BOUNDS_US)})

    def _write(self, obj: dict):
        self._fh.write(json.dumps(obj, sort_keys=True,
                                  separators=(",", ":")) + "\n")
        self._fh.flush()

    def sample(self, window: int, sim_ns: int, hist, stats,
               conns: int | None = None):
        """One chunk-boundary sample from the cumulative histogram and
        [H, N_STATS] stats (numpy); no wall clock anywhere."""
        table = fold(hist)
        tot = {name: int(stats[:, col].sum())
               for name, col in self._stat_cols}
        prev_t = self._prev_tot or {k: 0 for k in tot}
        prev_h = (self._prev_hist or
                  [[0] * len(r) for r in table])
        rec = {
            "window": int(window),
            "sim_ns": int(sim_ns),
            "totals": tot,
            "delta": {k: tot[k] - prev_t[k] for k in tot},
            "hist": table,
            "hist_delta": [[a - b for a, b in zip(ra, rb)]
                           for ra, rb in zip(table, prev_h)],
        }
        if conns is not None:
            rec["conns"] = int(conns)
        self._prev_tot, self._prev_hist = tot, table
        self._last_table = table
        self.records.append(rec)
        if self._fh:
            self._write(rec)

    def summary(self) -> dict:
        """:func:`report` of the latest sampled histogram."""
        return report(self._last_table) if self._last_table else {}

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def read_stream(path: str) -> tuple[dict, list]:
    """Parse a netscope JSONL stream -> (header, records); a missing
    header is synthesized."""
    header = {"format": FORMAT, "kinds": list(KIND_NAMES),
              "bounds_us": list(BOUNDS_US)}
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if "format" in obj:
                header = obj
            else:
                records.append(obj)
    return header, records


def publish(registry, network: dict):
    """A :func:`report` payload as ``net.*`` gauges (the metrics.json
    ``net`` section)."""
    for name, k in (network or {}).get("kinds", {}).items():
        registry.gauge(f"net.{name}.count").set(int(k["count"]))
        registry.gauge(f"net.{name}.p50_us").set(int(k["p50_us"]))
        registry.gauge(f"net.{name}.p90_us").set(int(k["p90_us"]))
        registry.gauge(f"net.{name}.p99_us").set(int(k["p99_us"]))
        for i, c in enumerate(k.get("buckets", ())):
            if c:
                registry.gauge(f"net.{name}.bucket.{i}").set(int(c))
