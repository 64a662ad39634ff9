"""passcope — per-pass device time and lockstep occupancy.

Counterpart of ``shadow_tpu/obs/passcope.py``. obs.perf attributes host
wall time to run phases and obs.memscope attributes bytes; this module
attributes the time spent inside the window loop to the stateflow
entries the reference names (``PASS_LABELS``: drain, exchange,
cap_peaks, advance, nic.tx, nic.rx_admit, tcp.rx, tcp.timer,
udp.deliver), and measures how much of each lockstep pass stepped rows
with nothing to do.

- **Labels.** ``engine/window.py`` and the handlers enter
  ``torch.profiler.record_function`` scopes named after the entries,
  through :func:`scope`, only while a :class:`Capture` is active: with
  passcope off a run issues exactly the operations it issued before.
- **Attribution** (:func:`attribute`). On the card each kernel goes to
  the innermost label among the CPU ranges around the op that launched
  it (the profiler links a kernel to its launching op; the ranges nest
  by time on the op's thread). On the CPU each op's self time goes to
  its innermost label. Host waits for the card (``cudaStreamSynchronize``,
  the copies behind ``.tolist()`` and ``int()``) are not compute: they
  go to ``runtime_ms``, as the reference's runtime waits do, and are
  split per label beside the host issue time. At least
  :data:`MIN_ATTRIBUTED` of the time must land on labels, or the
  result flags itself and names the residual's top operations.
- **Occupancy** (:func:`occupancy`): the reference's lane arithmetic.
  The port has no rungs, so its pass mix is ``{"dense": (H, passes)}``
  with batch 1, and its ``waste_frac`` is ``SimReport.waste_frac``
  rounded to 4 places with utilization clamped at 1.

The reference's xplane decoder has no counterpart: torch.profiler
hands the events over directly. Profiling is observation only; a
passcope run's stats and digest chain equal a plain run's.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os

PASS_LABELS = (
    "drain", "exchange", "exchange.sharded", "cap_peaks", "advance",
    "nic.tx", "nic.rx_admit", "tcp.rx", "tcp.timer", "udp.deliver",
)

MIN_ATTRIBUTED = 0.90
RESIDUAL = "unattributed (device glue)"

DEFAULT_TRACE_CHUNKS = 8

# host-side CUDA runtime calls that wait for the card: the syncs behind
# .tolist()/int()/bool() and the copies that carry their results back
_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
          "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync")

# set while a Capture is tracing; scope() reads it
ACTIVE = False
_NULL = contextlib.nullcontext()


def scope(label: str):
    """A ``record_function`` range named `label` while a capture is
    active, else a no-op context (no operation, no profiler call)."""
    if not ACTIVE:
        return _NULL
    import torch
    return torch.profiler.record_function(label)


# --- attribution -----------------------------------------------------------

def records(kineto_events) -> list:
    """Profiler events (``profile.profiler.kineto_results.events()``)
    as (name, on_device, thread, start_ns, end_ns, corr, linked)
    tuples: `corr` is a host op's correlation id, `linked` the id of
    the host op that launched a device event or a runtime call (0 for
    host ops and ranges). Reading the raw events skips torch's own
    post-processing, which takes minutes on a large trace."""
    out = []
    for e in kineto_events:
        if e.is_async():
            continue
        start = e.start_ns()
        out.append((e.name(), not str(e.device_type()).endswith("CPU"),
                    e.start_thread_id(), start, start + e.duration_ns(),
                    e.correlation_id(), e.linked_correlation_id()))
    return out


def attribute(recs, device: str):
    """Map trace records (:func:`records`) onto pass labels.

    Host ops nest per thread by their time ranges; each op's label is
    the innermost label range around it, and its self time is its
    range less its direct children's. On ``cuda`` the time is device
    time: every device event goes to the label of the host op that
    launched it, except device-to-host copies, which carry the host
    syncs' results and count as runtime. On ``cpu`` the time is each
    op's self time. Host waits for the card (:data:`_WAITS`) go to
    ``runtime_ms``, not to the total. Per label, ``host_ms`` is the
    host self time of its ops and ranges less their waits (the issue
    time; on the CPU it includes the compute), ``sync_ms`` the waits.

    -> {"phases": {label: {"ms", "frac", "host_ms", "sync_ms"}},
        "rungs": {}, "total_ms", "attributed_ms", "attributed_frac",
        "ok", "runtime_ms", "residual_ms", "residual_frac",
        "residual_label", "residual_top": [{"op", "ms"}]}
    """
    cuda = device == "cuda"
    ops = collections.defaultdict(list)      # thread -> host op records
    linked = []                              # device events, runtime calls
    for r in recs:
        if r[6] > 0 or r[1]:
            linked.append(r)
        else:
            ops[r[2]].append(r)
    label_of = {}                # host op corr -> innermost label
    self_ns = {}                 # host op corr -> self ns
    for evs in ops.values():
        evs.sort(key=lambda r: (r[3], -r[4]))
        stack = []          # [end_ns, corr, label, child ns, dur ns]
        for name, _dev, _thr, start, end, corr, _lnk in evs:
            while stack and stack[-1][0] <= start:
                top = stack.pop()
                self_ns[top[1]] = top[4] - top[3]
            outer = stack[-1][2] if stack else None
            label = name if name in PASS_LABELS else outer
            label_of[corr] = label
            if stack:
                stack[-1][3] += end - start
            stack.append([end, corr, label, 0, end - start])
        while stack:
            top = stack.pop()
            self_ns[top[1]] = top[4] - top[3]
    names = {r[5]: r[0] for evs in ops.values() for r in evs}

    phases = collections.Counter()
    host = collections.Counter()
    sync = collections.Counter()
    resid = collections.Counter()
    waits = collections.Counter()            # host op corr -> wait ns
    runtime = total = 0
    for name, on_dev, _thr, start, end, _corr, lnk in linked:
        dur = end - start
        label = label_of.get(lnk)
        if not on_dev:
            if name in _WAITS:
                runtime += dur
                waits[lnk] += dur
                if label is not None:
                    sync[label] += dur
            continue
        if not cuda or name in PASS_LABELS:
            continue            # a label's device-side annotation range
        if "DtoH" in name:
            runtime += dur
            continue
        total += dur
        if label is not None:
            phases[label] += dur
        else:
            resid[names.get(lnk, name)] += dur
    for corr, own in self_ns.items():
        name = names[corr]
        label = label_of[corr]
        own -= waits.get(corr, 0)
        if label is not None:
            host[label] += own
        if not cuda and name not in PASS_LABELS:
            total += own
            if label is not None:
                phases[label] += own
            else:
                resid[name] += own
    attributed = sum(phases.values())
    frac = attributed / total if total else 0.0
    labels = sorted(set(phases) | set(host) | set(sync),
                    key=lambda k: (-phases[k], k))
    return {
        "phases": {k: {"ms": round(phases[k] / 1e6, 3),
                       "frac": (round(phases[k] / total, 4)
                                if total else 0.0),
                       "host_ms": round(host[k] / 1e6, 3),
                       "sync_ms": round(sync[k] / 1e6, 3)}
                   for k in labels},
        "rungs": {},
        "total_ms": round(total / 1e6, 3),
        "attributed_ms": round(attributed / 1e6, 3),
        "attributed_frac": round(frac, 4),
        "ok": frac >= MIN_ATTRIBUTED,
        "runtime_ms": round(runtime / 1e6, 3),
        "residual_ms": round((total - attributed) / 1e6, 3),
        "residual_frac": round(1.0 - frac, 4) if total else 0.0,
        "residual_label": RESIDUAL,
        "residual_top": [{"op": k, "ms": round(v / 1e6, 3)}
                         for k, v in sorted(resid.items(),
                                            key=lambda kv: -kv[1])[:8]],
    }


def top_pass(dev):
    """-> (label, frac) of the largest attributed pass, or (None, 0)."""
    ph = (dev or {}).get("phases") or {}
    if not ph:
        return None, 0.0
    lbl = max(ph, key=lambda k: ph[k]["ms"])
    return lbl, ph[lbl]["frac"]


# --- lockstep occupancy ----------------------------------------------------

def occupancy(pass_mix, events, batch):
    """Lockstep efficiency from the drain's own pass accounting (the
    reference's arithmetic, kept whole).

    pass_mix: {label: (width, n_passes)}; the port's is
    ``{"dense": (H, passes)}``. events: executed events over the same
    span (a chained NIC-TX included, so utilization is clamped at 1).
    batch: event slots per gathered lane of a sparse pass (dense
    passes run one; the port passes 1).

    -> {"lane_steps", "events", "passes", "utilization", "waste_frac",
        "per_rung": {label: {"width", "passes", "batch",
                             "lane_steps", "min_fill"}}}
    """
    per_rung = {}
    lane_steps = 0
    passes = 0
    ws = sorted((int(lbl[1:]), lbl) for lbl in pass_mix
                if lbl.startswith("w") and lbl[1:].isdigit())
    ks = sorted((int(lbl[1:]), lbl) for lbl in pass_mix
                if lbl.startswith("k") and lbl[1:].isdigit())

    def _min_fill(lbl, width):
        for sizes in (ws, ks):
            order = [s for s, _ in sizes]
            for j, (s, l) in enumerate(sizes):
                if l == lbl:
                    prev = order[j - 1] if j else 0
                    return (prev + 1) / width if width else 0.0
        if lbl == "dense":
            prev = max([s for s, _ in ws + ks], default=0)
            return (prev + 1) / width if width else 0.0
        return 0.0
    for lbl, (width, n) in pass_mix.items():
        width, n = int(width), int(n)
        b = 1 if lbl == "dense" else max(1, int(batch))
        steps = n * width * b
        lane_steps += steps
        passes += n
        per_rung[lbl] = {
            "width": width, "passes": n, "batch": b,
            "lane_steps": steps,
            "min_fill": round(_min_fill(lbl, width), 4),
        }
    util = min(1.0, events / lane_steps) if lane_steps else 0.0
    return {
        "lane_steps": int(lane_steps),
        "events": int(events),
        "passes": int(passes),
        "utilization": round(util, 4),
        "waste_frac": round(1.0 - util, 4),
        "per_rung": per_rung,
    }


def shard_occupancy(shard_passes, shard_events, width):
    """Per-shard occupancy of a mesh run (the reference's
    ``shard_occupancy``): each shard's utilization ``events_s /
    (passes_s x width)`` over its own dense passes of `width` rows.

    -> {"per_shard": [waste_frac...], "utilization": [...],
        "skew": max/mean of the utilizations (1.0 = balanced)}"""
    wastes, utils = [], []
    for n, ev in zip(shard_passes, shard_events):
        o = occupancy({"dense": (width, int(n))}, int(ev), 1)
        wastes.append(o["waste_frac"])
        utils.append(o["utilization"])
    mean = sum(utils) / len(utils) if utils else 0.0
    skew = (max(utils) / mean) if mean else 0.0
    return {"per_shard": wastes, "utilization": utils,
            "skew": round(skew, 4)}


# --- capture ---------------------------------------------------------------

class Capture:
    """torch.profiler around the first `max_chunks` window chunks of a
    run (``SHADOW_TPU_PASSCOPE_CHUNKS``, default 8). Nothing is
    compiled, so tracing starts at the first chunk; a chunk is traced
    whole (chunk_windows windows), so a long chunk is a long trace.
    A profiler that refuses to start degrades to ``available: False``
    with the error recorded, never a crash."""

    def __init__(self, trace_dir, device, max_chunks=None):
        self.trace_dir = trace_dir
        self.device = str(getattr(device, "type", device))
        self.max_chunks = max_chunks or int(os.environ.get(
            "SHADOW_TPU_PASSCOPE_CHUNKS", str(DEFAULT_TRACE_CHUNKS)))
        self.prof = None
        self.stopped = False
        self.error = None
        self.chunks = 0

    def start(self):
        global ACTIVE
        if self.prof is not None or self.stopped:
            return
        try:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            ACTIVE = True
        except (RuntimeError, AssertionError, ValueError) as e:
            self.prof = None
            self.error = repr(e)
            self.stopped = True

    def chunk_done(self):
        if self.prof is None or self.stopped:
            return
        self.chunks += 1
        if self.chunks >= self.max_chunks:
            self.stop()

    def stop(self):
        global ACTIVE
        ACTIVE = False
        if self.prof is not None and not self.stopped:
            try:
                self.prof.__exit__(None, None, None)
            except RuntimeError as e:
                self.error = self.error or repr(e)
        self.stopped = True

    def result(self):
        """-> the device_phases dict (attribute() output plus
        available / device / trace_dir / chunks_traced), or
        available: False. The pass table is written beside the trace
        as passcope.json by the run."""
        self.stop()
        base = {"trace_dir": self.trace_dir, "device": self.device,
                "chunks_traced": self.chunks}
        if self.error:
            return {"available": False, "error": self.error, **base}
        if self.prof is None:
            return {"available": False,
                    "error": "no chunk was traced", **base}
        recs = records(self.prof.profiler.kineto_results.events())
        if not recs:
            return {"available": False,
                    "error": "no events in trace", **base}
        out = attribute(recs, self.device)
        out["available"] = True
        out.update(base)
        return out


def write_json(trace_dir, dev, occ):
    """passcope.json in the run's trace directory: the pass table and
    the occupancy block (tools/trace_report.py merges it)."""
    try:
        os.makedirs(trace_dir, exist_ok=True)
        with open(os.path.join(trace_dir, "passcope.json"), "w") as f:
            json.dump({"device_phases": dev, "occupancy": occ}, f,
                      indent=1, sort_keys=True)
    except OSError:
        pass


# --- publishing ------------------------------------------------------------

def publish(registry, occ=None, dev=None, shards=None):
    """passcope.* / occupancy.* gauges — the sections
    obs.metrics.Registry.snapshot() assembles into metrics.json; a mesh
    run's `shards` (``shard_occupancy``) adds the per-shard waste and
    the skew."""
    if occ:
        registry.gauge("occupancy.waste_frac").set(occ["waste_frac"])
        registry.gauge("occupancy.utilization").set(occ["utilization"])
        registry.gauge("occupancy.lane_steps").set(occ["lane_steps"])
        registry.gauge("occupancy.passes").set(occ["passes"])
        for lbl, r in occ["per_rung"].items():
            registry.gauge(
                f"occupancy.rung_passes.{lbl}").set(r["passes"])
            registry.gauge(
                f"occupancy.rung_lane_steps.{lbl}").set(r["lane_steps"])
    if shards:
        registry.gauge("occupancy.shard_skew").set(shards["skew"])
        for i, w in enumerate(shards["per_shard"]):
            registry.gauge(f"occupancy.shard_waste.{i}").set(w)
    if dev and dev.get("available"):
        registry.gauge("passcope.total_ms").set(dev["total_ms"])
        registry.gauge("passcope.attributed_frac").set(
            dev["attributed_frac"])
        registry.gauge("passcope.residual_ms").set(dev["residual_ms"])
        for lbl, ph in dev["phases"].items():
            registry.gauge(f"passcope.phase_ms.{lbl}").set(ph["ms"])


def format_report(dev=None, occ=None):
    """The --passcope print: the pass table (device ms, share, host
    issue and sync ms per label) and the occupancy block."""
    lines = []
    if dev is not None:
        if not dev.get("available"):
            lines.append("passcope: device trace unavailable — "
                         f"{dev.get('error')}")
        else:
            lines.append(f"passcope: device pass table "
                         f"({dev['total_ms']:.1f} ms {dev['device']} "
                         f"time, {dev['chunks_traced']} chunks traced)")
            lines.append(f"  {'pass':<18} {'ms':>10} {'share':>7} "
                         f"{'host_ms':>10} {'sync_ms':>10}")
            for lbl, ph in dev["phases"].items():
                lines.append(f"  {lbl:<18} {ph['ms']:>10.2f} "
                             f"{100 * ph['frac']:>6.1f}% "
                             f"{ph['host_ms']:>10.2f} "
                             f"{ph['sync_ms']:>10.2f}")
            lines.append(f"  {dev['residual_label']:<18} "
                         f"{dev['residual_ms']:>10.2f} "
                         f"{100 * dev['residual_frac']:>6.1f}%")
            if dev.get("runtime_ms"):
                lines.append(f"  (runtime waits excluded: "
                             f"{dev['runtime_ms']:.1f} ms)")
            if not dev["ok"]:
                lines.append(
                    f"  WARNING: only "
                    f"{100 * dev['attributed_frac']:.1f}% attributed "
                    f"(floor {100 * MIN_ATTRIBUTED:.0f}%) — top "
                    "residual ops: " + ", ".join(
                        r["op"] for r in dev["residual_top"][:3]))
    if occ:
        lines.append(
            f"occupancy: waste_frac={occ['waste_frac']:.3f} "
            f"(events={occ['events']} over {occ['lane_steps']} "
            f"lane-steps, {occ['passes']} passes)")
        for lbl, r in occ["per_rung"].items():
            if r["passes"]:
                lines.append(
                    f"  rung {lbl:<8} passes={r['passes']:<8} "
                    f"width={r['width']:<7} batch={r['batch']} "
                    f"min_fill={r['min_fill']:.3f}")
    return "\n".join(lines)
