"""Device memory of a run: the watermark and the state byte census.

Counterpart of ``shadow_tpu/obs/memscope.py``.

- **Watermark** (:class:`Watermark`): one sample() per window chunk, a
  handful of host-side reads and never a device sync. On the card the
  peak is the CUDA caching allocator's ``max_memory_allocated`` since
  the run began (``source: "device"``); on the CPU it is the process's
  current resident set (``source: "rss"``). It feeds the tracker's
  ``dev=`` column and ``SimReport.memory``.
- **Census** (:func:`state_census`): per-field bytes of the
  ``Hosts``/``HostParams``/``Shared`` tensors at the run's H, rolled up
  by ``engine.state.STATE_SECTIONS`` and split hot/cold by the
  reference's declaration (``engine.state.HOT_FIELDS``), read from
  shapes and dtypes only (no operation, no sync). The stdlib dims
  tables (:data:`HOSTS_DIMS`, :data:`HP_DIMS`) are the reference's. The
  port's device state is wide, so its census equals the reference's at
  ``wide_state=1``; the narrow overlay (:data:`NARROW_DTYPES`) gives
  the at-rest bytes of a snapshot.

The reference's compiled-program capture (``observe_executable``,
``program_footprint``, ``donation_audit``) reads XLA's cost and memory
analyses; eager torch has no counterpart.
"""

from __future__ import annotations

import dataclasses
import os
import resource

import torch

from ..engine.defs import N_STATS
from ..engine.state import NARROW_SPEC, NS_BUCKETS, NS_KINDS, SACK_K
from ..net.packet import PKT_WORDS


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
    """Per-run memory high water of the run's torch device, or of each
    distinct device of a mesh (``per_device``, in shard order; one card
    holding four shards counts once)."""

    def __init__(self, device):
        devs = device if isinstance(device, (list, tuple)) else [device]
        self.devices = [torch.device(d) for d in devs]
        self.device = self.devices[0]
        self._probed = False
        self.source = "device" if self.device.type == "cuda" else "rss"
        self.peak_bytes = 0
        self.per_device = [0] * len(self.devices)
        self.lifetime_peak_bytes = 0
        self.baseline_bytes = 0
        self.samples = 0

    def _probe(self):
        self._probed = True
        if self.source == "device":
            # the allocator's peak counter restarts with this run, so an
            # earlier run in the process cannot leak its peak into ours
            for d in self.devices:
                self.lifetime_peak_bytes = max(
                    self.lifetime_peak_bytes,
                    torch.cuda.max_memory_allocated(d))
                torch.cuda.reset_peak_memory_stats(d)
                self.baseline_bytes += torch.cuda.memory_allocated(d)
        else:
            self.baseline_bytes = current_rss_bytes()

    def sample(self) -> int:
        """Take one sample; returns the running per-run peak in bytes
        (the sum over the devices' peaks)."""
        if not self._probed:
            self._probe()
        if self.source == "device":
            for i, d in enumerate(self.devices):
                self.per_device[i] = max(self.per_device[i],
                                         torch.cuda.max_memory_allocated(d))
            cur = life = sum(self.per_device)
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
            "per_device": ([int(b) for b in self.per_device]
                           if self.source == "device" else None),
            "samples": self.samples,
        }


def publish(registry, watermark: dict = None, census: dict = None) -> None:
    """A run's memory figures as ``mem.*`` gauges (the metrics.json
    ``memory`` section): the watermark and the census totals."""
    if watermark:
        registry.gauge("mem.peak_bytes").set(watermark["peak_bytes"])
        registry.gauge("mem.delta_bytes").set(watermark["delta_bytes"])
        for i, v in enumerate(watermark.get("per_device") or ()):
            registry.gauge(f"mem.device_peak_bytes.{i}").set(v)
    if census:
        registry.gauge("mem.state_bytes").set(census["bytes"])
        registry.gauge("mem.state_bytes_per_host").set(
            census["per_host"])
        registry.gauge("mem.hot_state_bytes").set(
            census["hosts"]["hot"]["runtime_bytes"])


# --- the stdlib shape tables (the reference's, verbatim) -------------------

DTYPE_BYTES = {"i64": 8, "i32": 4, "u32": 4, "f32": 4, "bool": 1,
               "i16": 2, "u16": 2, "i8": 1}
DTYPE_NAMES = {"i64": "int64", "i32": "int32", "u32": "uint32",
               "f32": "float32", "bool": "bool",
               "i16": "int16", "u16": "uint16", "i8": "int8"}

HOSTS_DIMS = (
    ("eq_time", ("Q",), "i64"),
    ("eq_seq", ("Q",), "i32"),
    ("eq_kind", ("Q",), "i32"),
    ("eq_pkt", ("Q", "PKT"), "i32"),
    ("eq_ctr", (), "i32"),
    ("eq_next", (), "i64"),
    ("rng_ctr", (), "i32"),
    ("cpu_avail", (), "i64"),
    ("nic_busy", (), "i64"),
    ("nic_sched", (), "bool"),
    ("nic_rr", (), "i32"),
    ("nic_rx_until", (), "i64"),
    ("txq_pkt", ("T", "PKT"), "i32"),
    ("txq_head", (), "i32"),
    ("txq_cnt", (), "i32"),
    ("pkt_ctr", (), "i32"),
    ("next_eport", (), "i32"),
    ("sk_used", ("S",), "bool"),
    ("sk_proto", ("S",), "i32"),
    ("sk_state", ("S",), "i32"),
    ("sk_lport", ("S",), "i32"),
    ("sk_rport", ("S",), "i32"),
    ("sk_rhost", ("S",), "i32"),
    ("sk_parent", ("S",), "i32"),
    ("sk_snd_una", ("S",), "i64"),
    ("sk_snd_nxt", ("S",), "i64"),
    ("sk_snd_max", ("S",), "i64"),
    ("sk_snd_end", ("S",), "i64"),
    ("sk_rcv_nxt", ("S",), "i64"),
    ("sk_ooo_s", ("S", "K"), "i64"),
    ("sk_ooo_e", ("S", "K"), "i64"),
    ("sk_sack_s", ("S", "K"), "i64"),
    ("sk_sack_e", ("S", "K"), "i64"),
    ("sk_hole_end", ("S",), "i64"),
    ("sk_rex_nxt", ("S",), "i64"),
    ("sk_peer_fin", ("S",), "i64"),
    ("sk_fin_acked", ("S",), "bool"),
    ("sk_close_after", ("S",), "bool"),
    ("sk_cwnd", ("S",), "f32"),
    ("sk_ssthresh", ("S",), "f32"),
    ("sk_srtt", ("S",), "i64"),
    ("sk_rtt_min", ("S",), "i64"),
    ("sk_rttvar", ("S",), "i64"),
    ("sk_rto", ("S",), "i64"),
    ("sk_rto_deadline", ("S",), "i64"),
    ("sk_timer_on", ("S",), "bool"),
    ("sk_timer_gen", ("S",), "i32"),
    ("sk_dupacks", ("S",), "i32"),
    ("sk_rtt_seq", ("S",), "i64"),
    ("sk_rtt_time", ("S",), "i64"),
    ("sk_ctl", ("S",), "i32"),
    ("sk_peer_rwnd", ("S",), "i64"),
    ("sk_sndbuf", ("S",), "i64"),
    ("sk_rcvbuf", ("S",), "i64"),
    ("sk_hs_time", ("S",), "i64"),
    ("sk_last_tx", ("S",), "i64"),
    ("sk_syn_tag", ("S",), "i32"),
    ("sk_proc", ("S",), "i32"),
    ("sk_app_ref", ("S",), "i32"),
    ("sk_cc_wmax", ("S",), "f32"),
    ("sk_cc_epoch", ("S",), "i64"),
    ("sk_cc_k", ("S",), "f32"),
    ("app_node", ("PP",), "i32"),
    ("app_r", ("PP", 8), "i64"),
    ("app_proc", (), "i32"),
    ("tgen_sync", ("SY",), "i32"),
    ("ob_pkt", ("O", "PKT"), "i32"),
    ("ob_time", ("O",), "i64"),
    ("ob_cnt", (), "i32"),
    ("ob_next", (), "i64"),
    ("hw_time", ("HW",), "i64"),
    ("hw_pkt", ("HW", "PKT"), "i32"),
    ("hw_cnt", (), "i32"),
    ("hw_drop", (), "i32"),
    ("tr_time", ("TC",), "i64"),
    ("tr_pkt", ("TC", "PKT"), "i32"),
    ("tr_dir", ("TC",), "i32"),
    ("tr_cnt", (), "i32"),
    ("tr_drop", (), "i32"),
    ("stats", ("NST",), "i64"),
    ("ns_hist", ("NSK", "NSB"), "i64"),
    ("cap_peaks", (4,), "i32"),
)

# Shared fields that scale with H (classified by name, as the
# reference does); the topology oracle and the scalars are fixed cost
SHARED_PER_HOST_FIELDS = ("host_vertex", "host_bw_up", "host_bw_down")

HP_DIMS = (
    ("hid", (), "i32"),
    ("rng_stream", (), "u32"),
    ("vertex", (), "i32"),
    ("bw_up", (), "i64"),
    ("bw_down", (), "i64"),
    ("app_kind", ("PP",), "i32"),
    ("app_cfg", ("PP", 8), "i64"),
    ("nic_buf", (), "i64"),
    ("cpu_cost", (), "i64"),
    ("cpu_threshold", (), "i64"),
    ("rcvbuf0", (), "i64"),
    ("sndbuf0", (), "i64"),
    ("pcap_on", (), "bool"),
)

# the narrow at-rest dtypes: engine.state.NARROW_SPEC's projection
NARROW_DTYPES = {f: n for f, _w, n, _e, _b, _y in NARROW_SPEC}


def effective_dtype(field: str, dt: str, cfg=None) -> str:
    """The at-rest dtype of a Hosts column under this config: the
    NARROW_DTYPES overlay unless cfg asks for the wide layout. None =
    EngineConfig defaults = narrow."""
    wide = int(getattr(cfg, "wide_state", 0)) if cfg is not None else 0
    return dt if wide else NARROW_DTYPES.get(field, dt)


def dims_of(cfg=None) -> dict:
    """Symbolic-dim sizes from an EngineConfig (duck-typed; None = the
    EngineConfig defaults)."""
    def cap(name, default):
        return int(getattr(cfg, name, default)) if cfg is not None \
            else default

    return {
        "Q": cap("qcap", 32), "S": cap("scap", 16),
        "O": cap("obcap", 32), "T": cap("txqcap", 16),
        "PP": max(cap("procs_per_host", 1), 1),
        "SY": max(cap("synccap", 1), 1),
        "HW": max(cap("hostedcap", 1), 1),
        "TC": max(cap("tracecap", 0), 1),
        "K": SACK_K, "PKT": PKT_WORDS, "NST": N_STATS,
        "NSK": NS_KINDS,
        "NSB": NS_BUCKETS if cap("netscope", 0) else 0,
    }


def row_shape(dims_spec: tuple, dims: dict) -> tuple:
    """Concrete per-host trailing shape for a table row."""
    return tuple(d if isinstance(d, int) else dims[d]
                 for d in dims_spec)


def row_bytes(field: str, cfg=None, table=HOSTS_DIMS) -> int:
    """Per-host bytes of one column at this config (Hosts columns at
    their at-rest dtype, effective_dtype)."""
    dims = dims_of(cfg)
    for name, dspec, dt in table:
        if name == field:
            if table is HOSTS_DIMS:
                dt = effective_dtype(name, dt, cfg)
            n = DTYPE_BYTES[dt]
            for d in row_shape(dspec, dims):
                n *= d
            return n
    raise KeyError(f"unknown field {field!r}")


def table_row_bytes(cfg=None, table=HOSTS_DIMS) -> dict:
    """{field: per-host bytes} for a whole dims table, at the at-rest
    layout this config names."""
    dims = dims_of(cfg)
    out = {}
    for name, dspec, dt in table:
        if table is HOSTS_DIMS:
            dt = effective_dtype(name, dt, cfg)
        n = DTYPE_BYTES[dt]
        for d in row_shape(dspec, dims):
            n *= d
        out[name] = n
    return out


# --- the census ------------------------------------------------------------

def _tree_field_bytes(tree) -> dict:
    """{field: (bytes, dtype name, shape)} of a dataclass of tensors,
    from their metadata only."""
    out = {}
    for f in dataclasses.fields(tree):
        a = getattr(tree, f.name)
        n = a.element_size()
        for d in a.shape:
            n *= int(d)
        out[f.name] = (n, str(a.dtype).replace("torch.", ""),
                       tuple(int(d) for d in a.shape))
    return out


def state_census(cfg, hosts=None, hp=None, sh=None) -> dict:
    """The static byte census: per-field bytes at the run's H, rolled up
    by STATE_SECTIONS and split hot/cold by the reference's HOT_FIELDS
    and its config-gated hot_fields(cfg).

    With only `cfg` the Hosts shapes come from
    ``engine.state.shape_census`` (the meta device) and the HostParams
    bytes from HP_DIMS, and the topology-sized Shared is omitted; the
    live tensors (a Simulation's hosts/hp/sh) census what the run
    holds, Shared included."""
    from ..engine.state import (COLD_FIELDS, HOT_FIELDS, hot_fields,
                                section_of, shape_census)

    H = cfg.num_hosts

    def _nbytes(shape, dtype_name):
        n = {"int64": 8, "int32": 4, "uint32": 4, "float32": 4,
             "bool": 1, "int16": 2, "uint16": 2, "int8": 1}[dtype_name]
        for d in shape:
            n *= int(d)
        return n

    if hosts is not None:
        hosts_fields = _tree_field_bytes(hosts)
    else:
        hosts_fields = {f: (_nbytes(shape, dt), dt, shape)
                        for f, (shape, dt) in shape_census(cfg).items()}
    runtime_hot = set(hot_fields(cfg))

    fields = {}
    sections = {}
    hot_b = cold_b = runtime_b = 0
    for f, (b, dt, shape) in hosts_fields.items():
        sec = section_of(f)
        fields[f] = {"bytes": b, "per_host": b // max(H, 1),
                     "dtype": dt, "shape": list(shape),
                     "section": sec,
                     "hot": f in HOT_FIELDS,
                     "hot_runtime": f in runtime_hot}
        sections[sec] = sections.get(sec, 0) + b
        if f in COLD_FIELDS:
            cold_b += b
        else:
            hot_b += b
        if f in runtime_hot:
            runtime_b += b
    total_h = hot_b + cold_b

    out = {
        "H": H,
        "hosts": {
            "fields": fields,
            "bytes": total_h,
            "per_host": total_h // max(H, 1),
            "sections": sections,
            "hot": {
                "static_bytes": hot_b,
                "static_cold_bytes": cold_b,
                "runtime_bytes": runtime_b,
                "runtime_cold_bytes": total_h - runtime_b,
                "runtime_columns": len(runtime_hot),
            },
        },
    }

    if hp is not None:
        hpf = _tree_field_bytes(hp)
    else:
        hpf = {f: (row_bytes(f, cfg, HP_DIMS) * H,
                   DTYPE_NAMES[dt], None)
               for f, _, dt in HP_DIMS}
    hp_total = 0
    hp_fields = {}
    for f, (b, dt, _shape) in hpf.items():
        hp_fields[f] = {"bytes": b, "per_host": b // max(H, 1),
                        "dtype": dt}
        hp_total += b
    out["hp"] = {"fields": hp_fields, "bytes": hp_total,
                 "per_host": hp_total // max(H, 1)}

    sh_per_host = sh_fixed = 0
    if sh is not None:
        sh_fields = {}
        for f, (b, dt, _shape) in _tree_field_bytes(sh).items():
            scales = f in SHARED_PER_HOST_FIELDS
            sh_fields[f] = {"bytes": b, "dtype": dt,
                            "scales_with_h": scales}
            if scales:
                sh_per_host += b // max(H, 1)
            else:
                sh_fixed += b
        out["shared"] = {"fields": sh_fields,
                         "bytes": sh_per_host * H + sh_fixed,
                         "per_host": sh_per_host,
                         "fixed_bytes": sh_fixed}

    out["per_host"] = (out["hosts"]["per_host"] + out["hp"]["per_host"]
                       + sh_per_host)
    out["fixed_bytes"] = sh_fixed
    out["bytes"] = (out["hosts"]["bytes"] + out["hp"]["bytes"]
                    + (out["shared"]["bytes"] if sh is not None else 0))
    return out


def census_totals(census: dict) -> dict:
    """The census figures SimReport.memory carries beside the
    watermark (the reference's memory record keys)."""
    return {
        "state_bytes": census["bytes"],
        "state_bytes_per_host": census["per_host"],
        "hot_state_bytes": census["hosts"]["hot"]["runtime_bytes"],
        "cold_state_bytes": census["hosts"]["hot"]["runtime_cold_bytes"],
        "sections": census["hosts"]["sections"],
    }
