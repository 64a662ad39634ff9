"""Span tracing: a low-overhead recorder emitting Chrome trace-event
JSON (Perfetto, chrome://tracing, ``tools/trace_report.py``).

Counterpart of ``shadow_tpu/obs/trace.py``: named wall-clock spans
recorded on the host, serialized once at the end of the run. Each
chunk span carries its sim-time range, windows and events in ``args``,
so sim-time progress and wall cost line up in one view.

- Cheap when disabled: ``ENABLED`` is a module boolean; the per-chunk
  loop guards every hook with ``if trace.ENABLED:``, so a run without
  ``--trace`` pays one boolean check per chunk. ``span()`` is for cold
  paths (it allocates a generator even when disabled).
- Cheap when enabled: a span is two perf_counter_ns reads and one list
  append; ``MAX_EVENTS`` bounds memory and the drop count is recorded.
- One process-global tracer, so call sites need one import.

Timeline format: complete events (``"ph": "X"``) with microsecond
``ts``/``dur`` relative to the tracer's creation, wrapped as
``{"traceEvents": [...]}``.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager

ENABLED = False
TRACER = None

# retained-event cap: a runaway loop drops spans instead of memory
MAX_EVENTS = 1_000_000


class Tracer:
    """One trace session. `path=None` collects in memory and writes
    nothing at flush."""

    __slots__ = ("path", "events", "dropped", "_pid", "_epoch")

    def __init__(self, path: str | None):
        self.path = path
        self.events = []
        self.dropped = 0
        self._pid = os.getpid()
        self._epoch = time.perf_counter_ns()

    @staticmethod
    def now() -> int:
        """Span start stamp (perf_counter_ns) for complete()."""
        return time.perf_counter_ns()

    def complete(self, name: str, t0_ns: int, args: dict = None,
                 tid: int = 0):
        """Record a complete span [t0_ns, now) named `name`."""
        if len(self.events) >= MAX_EVENTS:
            self.dropped += 1
            return
        t1 = time.perf_counter_ns()
        ev = {"name": name, "ph": "X", "pid": self._pid, "tid": tid,
              "ts": (t0_ns - self._epoch) / 1000.0,
              "dur": (t1 - t0_ns) / 1000.0}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def flush(self):
        """Serialize the timeline (atomically); no-op with path=None."""
        if self.path is None:
            return
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "tid": 0, "args": {"name": "shadow_tpu_torch"}}]
        doc = {"traceEvents": meta + self.events,
               "displayTimeUnit": "ms"}
        if self.dropped:
            doc["otherData"] = {"dropped_events": self.dropped}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self.path)


def install(path: str | None) -> Tracer:
    """Enable tracing process-wide; the caller owns finish()."""
    global ENABLED, TRACER
    TRACER = Tracer(path)
    ENABLED = True
    return TRACER


def finish() -> Tracer | None:
    """Disable tracing and write the timeline (if a path was given);
    returns the retired tracer."""
    global ENABLED, TRACER
    tr, TRACER, ENABLED = TRACER, None, False
    if tr is not None:
        tr.flush()
    return tr


@contextmanager
def span(name: str, **args):
    """Cold-path span context manager (hot loops use ``if
    trace.ENABLED:`` and complete())."""
    if not ENABLED:
        yield
        return
    tr = TRACER
    t0 = tr.now()
    try:
        yield
    finally:
        tr.complete(name, t0, args or None)
