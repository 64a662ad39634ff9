"""Durable perf ledger: an append-only JSONL trajectory of measured
throughput, keyed by scenario x config fingerprint x platform.

Counterpart of ``shadow_tpu/obs/ledger.py``, in its file format, so
``tools/perf_regress.py`` gates the port's entries as it gates the
reference's. Keying rules:

- entries are compared only within one ``platform``, here the torch
  device type (``"cuda"`` or ``"cpu"``): a card number and a CPU
  number never form one trajectory;
- ``fingerprint`` hashes the engine config and the scenario knobs, so
  a deliberate config change starts a new trajectory; the port's CLI
  adds ``engine="torch"`` to the knobs, and every entry carries an
  ``engine`` field, so a port run and a reference run of one scenario
  never share a trajectory (the reference's entries have neither);
- ``git_rev`` is recorded for audit, never used for grouping.

One JSON object per line, append-only; a torn last line is skipped on
read. Default location: ``perf/ledger.jsonl`` at the repo root;
``SHADOW_TPU_LEDGER`` overrides the path (``off`` disables appends).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import time

FORMAT = "shadow_tpu.perf.ledger"
VERSION = 1
ENGINE = "torch"    # this package's entries (the `engine` field and key)

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def default_path() -> str | None:
    """The path appends resolve to: SHADOW_TPU_LEDGER if set (``off``,
    ``0``, ``none`` or empty disable appends -> None), else
    ``perf/ledger.jsonl`` at the repo root."""
    env = os.environ.get("SHADOW_TPU_LEDGER")
    if env is not None:
        if env.strip().lower() in ("", "0", "off", "none"):
            return None
        return env
    return os.path.join(_REPO_ROOT, "perf", "ledger.jsonl")


def fingerprint_of(cfg=None, **extra) -> str:
    """Stable 16-hex fingerprint of an EngineConfig (or any dict) plus
    keyword extras; key order never matters."""
    d = {}
    if cfg is not None:
        d["cfg"] = (dataclasses.asdict(cfg)
                    if dataclasses.is_dataclass(cfg) else dict(cfg))
    if extra:
        d["extra"] = extra
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def git_rev() -> str | None:
    import subprocess
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5, cwd=_REPO_ROOT)
        return out.stdout.strip() or None
    except Exception:
        return None


def make_entry(scenario: str, fingerprint: str, platform: str,
               summary: dict, phases: dict = None,
               attributed_frac: float = None, cfg=None,
               note: str = None) -> dict:
    """One ledger line from a run's summary (SimReport.summary()).
    `phases` is the per-phase wall map from obs.perf ({phase: wall_s});
    `cfg` stamps the engine knobs a rate move is read against. The
    port compiles nothing, so an entry has no cold/warm split and the
    gate compares its whole-run rate. `note` says how to read the
    entry (a batch lane's wall is the whole batch's)."""
    e = {
        "format": FORMAT, "version": VERSION,
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "scenario": scenario,
        "fingerprint": fingerprint,
        "platform": platform,
        "engine": ENGINE,
        "git_rev": git_rev(),
        "events": int(summary.get("events", 0)),
        "sim_seconds": summary.get("sim_seconds"),
        "windows": summary.get("windows"),
        "wall_seconds": round(summary.get("wall_seconds", 0.0), 3),
        "cold_wall": None,
        "warm_wall": None,
        "events_per_sec": round(summary.get("events_per_sec", 0.0), 1),
        "warm_events_per_sec": None,
    }
    if note:
        e["note"] = note
    if summary.get("device"):
        e["device"] = summary["device"]
    if summary.get("passes"):
        e["passes"] = int(summary["passes"])
        if summary.get("windows"):
            e["passes_per_window"] = round(
                summary["passes"] / summary["windows"], 3)
    # the memory watermark tools/perf_regress.py's memory gate reads
    if summary.get("mem_peak_bytes"):
        e["mem_peak_bytes"] = int(summary["mem_peak_bytes"])
        if summary.get("mem_source"):
            e["mem_source"] = summary["mem_source"]
    if summary.get("state_bytes_per_host"):
        e["state_bytes_per_host"] = int(summary["state_bytes_per_host"])
    # netscope tails (netscope runs only)
    if "rtt_p50_us" in summary:
        e["rtt_p50_us"] = int(summary["rtt_p50_us"])
        e["rtt_p99_us"] = int(summary["rtt_p99_us"])
        e["completion_p99_s"] = summary.get("completion_p99_s")
    # the lockstep drain's wasted-lane fraction (the occupancy gate)
    if "waste_frac" in summary:
        e["waste_frac"] = summary["waste_frac"]
        if "top_pass" in summary:
            e["top_pass"] = summary["top_pass"]
            e["top_pass_frac"] = summary["top_pass_frac"]
    if phases:
        e["phases"] = {k: round(v, 4) for k, v in phases.items()}
    if attributed_frac is not None:
        e["attributed_frac"] = attributed_frac
    if cfg is not None and dataclasses.is_dataclass(cfg):
        e["extras"] = {"chunk_windows": cfg.chunk_windows,
                       "netscope": bool(cfg.netscope),
                       "tracecap": cfg.tracecap}
    return e


def entry_from_report(scenario: str, fingerprint: str, platform: str,
                      report, attribution: dict = None, **kw) -> dict:
    """One ledger line from a SimReport and an optional obs.perf
    attribution (the CLI's ``--perf``)."""
    phases = attributed = None
    if attribution is not None:
        phases = {p: r["wall_s"]
                  for p, r in attribution["phases"].items()}
        attributed = attribution["attributed_frac"]
    return make_entry(scenario=scenario, fingerprint=fingerprint,
                      platform=platform, summary=report.summary(),
                      phases=phases, attributed_frac=attributed, **kw)


def entry_rate(e: dict) -> float | None:
    """The rate the regression gate compares: warm events/s when the
    entry has a warm wall, else the whole-run rate."""
    return e.get("warm_events_per_sec") or e.get("events_per_sec")


def key_of(e: dict) -> tuple:
    """The trajectory key: scenario, platform, config fingerprint."""
    return (e.get("scenario"), e.get("platform"), e.get("fingerprint"))


def read(path: str) -> list:
    """All well-formed ledger entries, file order; a torn line (a writer
    killed mid-append) is skipped with a warning on stderr."""
    return jsonl_read(path, "ledger")


def jsonl_append(path: str, obj: dict, fsync: bool = False,
                 sort_keys: bool = False) -> None:
    """Append one JSON line; ``fsync=True`` makes it durable before
    returning (the fleet journal and crash-cause logs): a kill after
    the return cannot lose the record, only tear a line still in
    flight, which jsonl_read skips."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(obj, sort_keys=sort_keys) + "\n")
        f.flush()
        if fsync:
            os.fsync(f.fileno())


def jsonl_read(path: str, label: str = "jsonl") -> list:
    """All well-formed dict lines of a JSONL file, file order; a torn
    line is skipped with a warning on stderr naming `label`."""
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except json.JSONDecodeError:
                sys.stderr.write(
                    f"{label}: {path}:{i}: skipping malformed line "
                    "(torn append?)\n")
                continue
            if isinstance(e, dict):
                out.append(e)
    return out


def append(entry: dict, path: str = None) -> str | None:
    """Append one entry to `path` (default: default_path()); returns the
    path written, or None when the ledger is disabled."""
    if path is None:
        path = default_path()
    if path is None:
        return None
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(entry) + "\n")
    return path
