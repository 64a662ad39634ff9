"""Per-phase wall-cost attribution: every wall-millisecond named.

Counterpart of ``shadow_tpu/obs/perf.py``. The trace recorder
(``obs.trace``) spans every phase the run loop executes — setup, each
window chunk, pcap drains, tracker heartbeats, netscope samples,
checkpoint saves, digest records, fault applications, report
finalization — so attribution is span arithmetic: per-span self-time
(total minus directly nested children, the stack walk
``tools/trace_report.py`` uses), mapped through :data:`PHASE_OF` into
named phases, against the run's measured wall.

The contract: phases sum to >= :data:`MIN_ATTRIBUTED` of the wall, or
the report names the residual. On the graph path the first chunk
captures its CUDA graph (a ``jitcache.compile`` span, phase
``compile-miss``, as the reference's XML compile) and the kernel
library is built (``jitcache.compile``) or loaded from the disk tier
(``jitcache.load``, phase ``compile-hit``). Attribution is host-side and read-only: a ``--perf``
run's digest chain equals a plain run's.
"""

from __future__ import annotations

from collections import defaultdict

# span name -> phase name; spans not listed attribute under their own
# name, and the residual is only wall time no span covered
PHASE_OF = {
    "run.setup": "setup",
    "jitcache.compile": "compile-miss",  # a graph capture or a build
    "jitcache.load": "compile-hit",      # the library from the disk tier
    "chunk": "window",
    "hosting.step": "hosting",       # the hosted apps' CPU tier per window
    "pcap.drain": "pcap",
    "tracker.heartbeat": "tracker",
    "netscope.sample": "netscope",
    "checkpoint.save": "checkpoint",
    "digest.record": "digest",
    "faults.apply": "faults",
    "report.finalize": "finalize",
}

RESIDUAL = "unattributed (host loop glue)"

# the attribution-quality floor: below this the report flags itself
MIN_ATTRIBUTED = 0.90


def self_times(events) -> dict:
    """Per span name: [count, total_us, self_us]. Self-time excludes
    directly nested child spans per (pid, tid) track (an enclosing span
    sorts before the spans it contains via (ts, -dur))."""
    agg = {}
    tracks = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        tracks[(e.get("pid", 0), e.get("tid", 0))].append(e)
    for evs in tracks.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []  # [end_ts, child_sum_us, name, dur_us]

        def close(upto):
            while stack and stack[-1][0] <= upto + 1e-9:
                end, child, name, dur = stack.pop()
                a = agg.setdefault(name, [0, 0.0, 0.0])
                a[0] += 1
                a[1] += dur
                a[2] += max(dur - child, 0.0)
                if stack:
                    stack[-1][1] += dur

        for e in evs:
            close(e["ts"])
            stack.append([e["ts"] + e["dur"], 0.0, e["name"], e["dur"]])
        close(float("inf"))
    return agg


def attribute(events, wall_s: float, n_events: int = None) -> dict:
    """Attribute `wall_s` seconds of run wall to named phases from the
    trace `events` -> {"wall_s", "phases": {phase: {"wall_s", "frac",
    "count", "us_per_event"?}} (by wall, descending), "attributed_s",
    "attributed_frac", "residual_s", "residual_frac",
    "residual_label", "ok", "events"?}."""
    agg = self_times(events)
    walls = defaultdict(float)
    counts = defaultdict(int)
    for name, (c, _total, self_us) in agg.items():
        phase = PHASE_OF.get(name, name)
        walls[phase] += self_us / 1e6
        counts[phase] += c
    attributed = sum(walls.values())
    # spans can overlap the measured wall slightly; clamp
    residual = max(wall_s - attributed, 0.0)
    phases = {}
    for phase in sorted(walls, key=lambda p: -walls[p]):
        row = {"wall_s": round(walls[phase], 6),
               "frac": round(walls[phase] / wall_s, 4) if wall_s else 0.0,
               "count": counts[phase]}
        if n_events:
            row["us_per_event"] = round(walls[phase] * 1e6 / n_events, 3)
        phases[phase] = row
    frac = min(attributed / wall_s, 1.0) if wall_s else 0.0
    out = {
        "wall_s": round(wall_s, 6),
        "phases": phases,
        "attributed_s": round(min(attributed, wall_s), 6),
        "attributed_frac": round(frac, 4),
        "residual_s": round(residual, 6),
        "residual_frac": round(residual / wall_s, 4) if wall_s else 0.0,
        "residual_label": RESIDUAL,
        "ok": frac >= MIN_ATTRIBUTED,
    }
    if n_events is not None:
        out["events"] = int(n_events)
    return out


def publish(attribution: dict, registry) -> None:
    """An attribution as ``perf.*`` gauges (the metrics.json ``perf``
    section)."""
    for phase, row in attribution["phases"].items():
        key = phase.split(" ")[0]  # gauge-safe
        registry.gauge(f"perf.phase.{key}_s").set(row["wall_s"])
    registry.gauge("perf.attributed_frac").set(
        attribution["attributed_frac"])
    registry.gauge("perf.residual_s").set(attribution["residual_s"])


def format_report(attribution: dict) -> str:
    """Human-readable phase table (the --perf CLI output)."""
    lines = [f"== perf: phase attribution "
             f"({attribution['attributed_frac'] * 100:.1f}% of "
             f"{attribution['wall_s']:.3f}s wall attributed) =="]
    lines.append(f"{'phase':<12} {'wall_s':>10} {'frac':>7} "
                 f"{'count':>7} {'us/event':>10}")
    for phase, row in attribution["phases"].items():
        upe = row.get("us_per_event")
        lines.append(
            f"{phase:<12} {row['wall_s']:>10.3f} "
            f"{row['frac'] * 100:>6.1f}% {row['count']:>7} "
            f"{upe if upe is not None else '-':>10}")
    lines.append(
        f"{'residual':<12} {attribution['residual_s']:>10.3f} "
        f"{attribution['residual_frac'] * 100:>6.1f}%    "
        f"<- {attribution['residual_label']}")
    if not attribution["ok"]:
        lines.append(
            f"WARNING: only {attribution['attributed_frac'] * 100:.1f}% "
            f"of the wall is attributed (floor "
            f"{MIN_ATTRIBUTED * 100:.0f}%) — the unattributed "
            "remainder is host-side time between spans")
    return "\n".join(lines)
