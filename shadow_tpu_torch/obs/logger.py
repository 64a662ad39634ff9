"""Leveled simulation logger.

Counterpart of ``shadow_tpu/obs/logger.py``, with its line format::

    wall [shadow-tpu] sim-time [level] [host] message

Records originate on the host side only (the device reports through
counters), so the reference Shadow's asynchronous logger reduces to a
leveled writer with per-host level overrides. ``tools/parse_heartbeat.py``
reads the heartbeat lines it carries.
"""

from __future__ import annotations

import sys
import time

LEVELS = {"error": 0, "critical": 0, "warning": 1, "message": 2,
          "info": 3, "debug": 4}
DEFAULT_LEVEL = "message"


def _fmt_simtime(ns: int) -> str:
    s, rem = divmod(int(ns), 10**9)
    h, rem2 = divmod(s, 3600)
    m, sec = divmod(rem2, 60)
    return f"{h}:{m:02d}:{sec:02d}.{rem:09d}"


class SimLogger:
    def __init__(self, level: str = DEFAULT_LEVEL, stream=None):
        self.level = LEVELS.get(level, 2)
        self.host_levels = {}       # host name -> numeric level
        self.stream = stream or sys.stdout
        self._t0 = time.time()
        self.counts = dict.fromkeys(LEVELS, 0)

    def set_host_level(self, host: str, level: str):
        """Per-host override (the reference's <host loglevel=...>)."""
        self.host_levels[host] = LEVELS.get(level, 2)

    def log(self, level: str, sim_ns: int, host: str, msg: str):
        n = LEVELS.get(level, 2)
        self.counts[level] = self.counts.get(level, 0) + 1
        limit = self.host_levels.get(host, self.level)
        if n > limit:
            return
        wall = time.time() - self._t0
        wm, ws = divmod(wall, 60.0)
        self.stream.write(
            f"{int(wm):02d}:{ws:09.6f} [shadow-tpu] "
            f"{_fmt_simtime(sim_ns)} [{level}] [{host}] {msg}\n")

    def error(self, sim_ns, host, msg):
        self.log("error", sim_ns, host, msg)
        raise RuntimeError(f"[{host}] {msg}")

    def warning(self, sim_ns, host, msg):
        self.log("warning", sim_ns, host, msg)

    def message(self, sim_ns, host, msg):
        self.log("message", sim_ns, host, msg)

    def info(self, sim_ns, host, msg):
        self.log("info", sim_ns, host, msg)

    def debug(self, sim_ns, host, msg):
        self.log("debug", sim_ns, host, msg)
