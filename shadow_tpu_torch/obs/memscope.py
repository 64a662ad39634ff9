"""Device-memory watermark of a run.

Counterpart of the ``Watermark`` of ``shadow_tpu/obs/memscope.py``:
one sample() per window chunk, a handful of host-side reads and never
a device sync. On the card the peak is the CUDA caching allocator's
``max_memory_allocated`` since the run began (``source: "device"``);
on the CPU it is the process's current resident set (``source:
"rss"``). It feeds the tracker's ``dev=`` column and
``SimReport.memory``. The per-field state census and the compiled
programs' cost capture of the reference have no counterpart yet.
"""

from __future__ import annotations

import os
import resource

import torch


def rss_bytes() -> int:
    """This process's lifetime peak resident set (ru_maxrss is KiB on
    Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def current_rss_bytes() -> int:
    """This process's current resident set (/proc/self/statm); the
    lifetime figure where /proc is unavailable."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE")
    except (OSError, ValueError, IndexError):
        return rss_bytes()


class Watermark:
    """Per-run memory high water of the run's torch device."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self._probed = False
        self.source = "device" if self.device.type == "cuda" else "rss"
        self.peak_bytes = 0
        self.lifetime_peak_bytes = 0
        self.baseline_bytes = 0
        self.samples = 0

    def _probe(self):
        self._probed = True
        if self.source == "device":
            # the allocator's peak counter restarts with this run, so an
            # earlier run in the process cannot leak its peak into ours
            self.lifetime_peak_bytes = torch.cuda.max_memory_allocated(
                self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            self.baseline_bytes = torch.cuda.memory_allocated(self.device)
        else:
            self.baseline_bytes = current_rss_bytes()

    def sample(self) -> int:
        """Take one sample; returns the running per-run peak in bytes."""
        if not self._probed:
            self._probe()
        if self.source == "device":
            cur = torch.cuda.max_memory_allocated(self.device)
            life = cur
        else:
            cur = current_rss_bytes()
            life = rss_bytes()
        self.lifetime_peak_bytes = max(self.lifetime_peak_bytes, life)
        self.peak_bytes = max(self.peak_bytes, cur)
        self.samples += 1
        return self.peak_bytes

    def snapshot(self) -> dict:
        """The record SimReport.memory, the tracker and the ledger read:
        this run's peak, its growth over the pre-run baseline and the
        process-lifetime figure (context only)."""
        if not self._probed:
            self.sample()
        return {
            "source": self.source,
            "peak_bytes": int(self.peak_bytes),
            "baseline_bytes": int(self.baseline_bytes),
            "delta_bytes": int(max(self.peak_bytes
                                   - self.baseline_bytes, 0)),
            "lifetime_peak_bytes": int(max(self.lifetime_peak_bytes,
                                           self.peak_bytes)),
            "per_device": ([int(self.peak_bytes)]
                           if self.source == "device" else None),
            "samples": self.samples,
        }


def publish(registry, watermark: dict) -> None:
    """A watermark as ``mem.*`` gauges (the metrics.json ``memory``
    section)."""
    registry.gauge("mem.peak_bytes").set(watermark["peak_bytes"])
    registry.gauge("mem.delta_bytes").set(watermark["delta_bytes"])
    for i, v in enumerate(watermark.get("per_device") or ()):
        registry.gauge(f"mem.device_peak_bytes.{i}").set(v)
