"""Simulation state: dataclasses of device tensors.

Counterpart of ``shadow_tpu/engine/state.py``. Three objects hold the
whole simulation:

- :class:`Hosts` — every mutable per-host tensor, leading dim H, with
  the reference's 82 field names, order, dtypes and shapes in its
  WIDE layout. The window loop updates these tensors in place. The
  reference's narrow at-rest layout (``NARROW_SPEC``, its default
  ``wide_state=0``) exists here only as a numpy codec
  (``narrow_arrays``/``widen_arrays``) that checkpoints use on save
  and load, so snapshots pass between the two packages.
- :class:`HostParams` — read-only per-host configuration.
- :class:`Shared` — replicated tables and scalars: the vertex-by-vertex
  latency/reliability oracle, seed, stop time, lookahead window.

:class:`EngineConfig` carries every reference field, so configs and
fingerprints carry over. Knobs that only shape the reference's
lockstep schedule (``active_block``, ``event_batch``, ``hot_split``,
``exsortcap``, ``dstcap``) are accepted and have no effect here: the
reference holds every setting of them bit-identical. ``exchange_a2a``
and ``a2acap`` set a mesh run's exchange buckets (``parallel.shard``).
``wide_state`` picks the layout a checkpoint is stored in; the device
state is always wide.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..core import constants as C
from ..core.simtime import SIMTIME_MAX
from ..net.packet import PKT_WORDS
from .defs import N_STATS

SACK_K = 4          # SACK scoreboard ranges per socket (shadow_tpu/net/sack.py K)
NS_KINDS = 4        # network-observatory histogram kinds (obs/netscope.py)
NS_BUCKETS = 32


@dataclass(frozen=True)
class EngineConfig:
    """Static engine shape/size configuration (see the reference for
    the meaning of each knob)."""
    num_hosts: int
    qcap: int = 32
    scap: int = 16
    obcap: int = 32
    incap: int = 32
    txqcap: int = 16
    chunk_windows: int = 64
    cc_kind: int = 2
    hostedcap: int = 1
    app_kinds: tuple = None
    uses_tcp: bool = True
    qdisc: int = 1
    cpu_model: bool = False
    tracecap: int = 0
    synccap: int = 1
    procs_per_host: int = 1
    exchange_a2a: bool = True
    a2acap: int = 0
    active_block: int = -1
    exsortcap: int = 0
    dstcap: int = 0
    event_batch: int = 16
    hot_split: int = 1
    netscope: bool = False
    wide_state: int = 0


# Digest sections (obs.digest): Hosts field prefix -> the named state
# section a divergence report attributes to; fields matching no prefix
# digest under "other".
STATE_SECTIONS = (
    ("eq_", "event_queue"),
    ("rng_ctr", "rng"),
    ("cpu_avail", "cpu"),
    ("nic_", "nic"),
    ("txq_", "nic"),
    ("pkt_ctr", "nic"),
    ("next_eport", "nic"),
    ("sk_", "tcp"),
    ("app_", "app"),
    ("tgen_sync", "app"),
    ("ob_", "outbox"),
    ("hw_", "hosted_wakes"),
    ("tr_", "trace_ring"),
    ("stats", "stats"),
    ("ns_", "netscope"),
    ("cap_peaks", "stats"),
)


# The reference's hot/cold column declaration
# (``shadow_tpu/engine/state.py``: COLD_FIELDS, HOT_FIELDS, COLD_WHEN,
# ``hot_fields``). The port's drain moves every column, so nothing here
# shapes a pass; the memory census (obs.memscope) reads it to label
# each field as the reference's census does.
COLD_FIELDS = frozenset({
    "ob_next", "tr_time", "tr_pkt", "tr_dir", "tr_cnt", "tr_drop",
    "cap_peaks",
})

HOT_FIELDS = (
    "eq_time", "eq_seq", "eq_kind", "eq_pkt", "eq_ctr", "eq_next",
    "rng_ctr", "cpu_avail",
    "nic_busy", "nic_sched", "nic_rr", "nic_rx_until",
    "txq_pkt", "txq_head", "txq_cnt", "pkt_ctr", "next_eport",
    "sk_used", "sk_proto", "sk_state", "sk_lport", "sk_rport",
    "sk_rhost", "sk_parent", "sk_snd_una", "sk_snd_nxt", "sk_snd_max",
    "sk_snd_end", "sk_rcv_nxt", "sk_ooo_s", "sk_ooo_e", "sk_sack_s",
    "sk_sack_e", "sk_hole_end", "sk_rex_nxt", "sk_peer_fin",
    "sk_fin_acked", "sk_close_after", "sk_cwnd", "sk_ssthresh",
    "sk_srtt", "sk_rtt_min", "sk_rttvar", "sk_rto", "sk_rto_deadline",
    "sk_timer_on", "sk_timer_gen", "sk_dupacks", "sk_rtt_seq",
    "sk_rtt_time", "sk_ctl", "sk_peer_rwnd", "sk_sndbuf", "sk_rcvbuf",
    "sk_hs_time", "sk_last_tx", "sk_syn_tag", "sk_proc", "sk_app_ref",
    "sk_cc_wmax", "sk_cc_epoch", "sk_cc_k",
    "app_node", "app_r", "app_proc", "tgen_sync",
    "ob_pkt", "ob_time", "ob_cnt",
    "hw_time", "hw_pkt", "hw_cnt", "hw_drop",
    "stats", "ns_hist",
)

COLD_WHEN = (
    ("cpu_model_off", ("cpu_avail",)),
    ("no_hosted", ("hw_time", "hw_pkt", "hw_cnt", "hw_drop")),
    ("no_tgen", ("tgen_sync",)),
    ("no_tcp", (
        "sk_state", "sk_rport", "sk_rhost", "sk_parent", "sk_snd_una",
        "sk_snd_nxt", "sk_snd_max", "sk_ooo_s", "sk_ooo_e",
        "sk_sack_s", "sk_sack_e", "sk_hole_end", "sk_rex_nxt",
        "sk_peer_fin", "sk_fin_acked", "sk_close_after", "sk_cwnd",
        "sk_ssthresh", "sk_srtt", "sk_rtt_min", "sk_rttvar", "sk_rto",
        "sk_rto_deadline", "sk_timer_on", "sk_dupacks", "sk_rtt_seq",
        "sk_rtt_time", "sk_ctl", "sk_peer_rwnd", "sk_sndbuf",
        "sk_rcvbuf", "sk_hs_time", "sk_last_tx", "sk_syn_tag",
        "sk_app_ref", "sk_cc_wmax", "sk_cc_epoch", "sk_cc_k",
    )),
    ("no_tcp_single_proc", ("sk_proc",)),
    ("netscope_off", ("ns_hist",)),
)


def _guard_holds(guard: str, cfg: EngineConfig) -> bool:
    from ..apps.base import APP_HOSTED, APP_TGEN

    def has_app(kind):
        return cfg.app_kinds is None or kind in cfg.app_kinds

    no_hosted = cfg.hostedcap <= 1 and not has_app(APP_HOSTED)
    if guard == "cpu_model_off":
        return not cfg.cpu_model
    if guard == "no_hosted":
        return no_hosted
    if guard == "no_tgen":
        return not has_app(APP_TGEN)
    if guard == "no_tcp":
        return not cfg.uses_tcp and no_hosted
    if guard == "no_tcp_single_proc":
        return (not cfg.uses_tcp and no_hosted
                and cfg.procs_per_host <= 1)
    if guard == "netscope_off":
        return not cfg.netscope
    raise KeyError(f"unknown COLD_WHEN guard {guard!r}")


def hot_fields(cfg: EngineConfig) -> tuple:
    """The reference drain's runtime working set for this config:
    HOT_FIELDS minus each COLD_WHEN column whose guard holds; every
    field with ``hot_split == 0``."""
    if not cfg.hot_split:
        return tuple(f.name for f in fields(Hosts))
    off = set()
    for guard, flds in COLD_WHEN:
        if _guard_holds(guard, cfg):
            off.update(flds)
    return tuple(f for f in HOT_FIELDS if f not in off)


def section_of(field: str, *, strict: bool = False) -> str:
    """Digest section for a Hosts field; with strict=True an unmapped
    field raises instead of landing in "other"."""
    for prefix, section in STATE_SECTIONS:
        if field.startswith(prefix):
            return section
    if strict:
        raise KeyError(
            f"Hosts field {field!r} matches no STATE_SECTIONS prefix; "
            "add a (prefix, section) entry next to the field")
    return "other"


# The reference's narrow at-rest layout (its default, wide_state=0):
# (field, wide dtype, narrow dtype, encoding, bound, why). "abs" columns
# are cast; "rel:<anchor>" scoreboards are stored as offsets from their
# anchor column, with the -1 free-slot sentinel kept. Every bound is
# the reference's machine-checked one, so the round trip is exact.
NARROW_SPEC = (
    ("sk_ooo_s", "i64", "i32", "rel:sk_rcv_nxt", 1073741824,
     "receiver OOO runs lie in (rcv_nxt, rcv_nxt + rcvbuf]; "
     "rcvbuf <= buf_cap = 2^30"),
    ("sk_ooo_e", "i64", "i32", "rel:sk_rcv_nxt", 1073741824,
     "run ends share the OOO window bound"),
    ("sk_sack_s", "i64", "i32", "rel:sk_snd_una", 1073741824,
     "sender SACK runs lie in [snd_una, snd_una + sndbuf + rwnd)"),
    ("sk_sack_e", "i64", "i32", "rel:sk_snd_una", 1073741824,
     "run ends share the SACK window bound"),
    ("sk_snd_una", "i64", "i32", "abs", 2147483647,
     "the wire's i32 SEQ/ACK bounds every absolute stream offset"),
    ("sk_snd_nxt", "i64", "i32", "abs", 2147483647, "wire i32 SEQ"),
    ("sk_snd_max", "i64", "i32", "abs", 2147483647, "wire i32 SEQ"),
    ("sk_snd_end", "i64", "i32", "abs", 2147483647,
     "app write cursor; flow control caps it at snd_una + sndbuf"),
    ("sk_rcv_nxt", "i64", "i32", "abs", 2147483647, "wire i32 ACK"),
    ("sk_hole_end", "i64", "i32", "abs", 2147483647,
     "recovery point: a snapshot of snd_max"),
    ("sk_rex_nxt", "i64", "i32", "abs", 2147483647,
     "retransmit cursor within [snd_una, snd_max]"),
    ("sk_peer_fin", "i64", "i32", "abs", 2147483647,
     "peer FIN stream offset (-1 when unset)"),
    ("sk_rtt_seq", "i64", "i32", "abs", 2147483647,
     "RTT-sampled SEQ (-1 between samples)"),
    ("sk_peer_rwnd", "i64", "i32", "abs", 1073741824,
     "peer-advertised window, clamped to buf_cap = 2^30"),
    ("sk_sndbuf", "i64", "i32", "abs", 1073741824,
     "send buffer, autotuned within [min, 2^30]"),
    ("sk_rcvbuf", "i64", "i32", "abs", 1073741824,
     "receive buffer, autotuned within [min, 2^30]"),
    ("sk_proto", "i32", "i8", "abs", 17, "IPPROTO id"),
    ("sk_state", "i32", "i8", "abs", 10, "TCPS_* enum"),
    ("sk_ctl", "i32", "i8", "abs", 31, "pending-control bitmask"),
    ("sk_lport", "i32", "u16", "abs", 65535, "ports <= 65535"),
    ("sk_rport", "i32", "u16", "abs", 65535, "ports <= 65535"),
)

_DTYPES = {"i8": "int8", "i16": "int16", "u16": "uint16",
           "i32": "int32", "i64": "int64"}
NARROW_ABS = {f: (_DTYPES[w], _DTYPES[n])
              for f, w, n, enc, _b, _y in NARROW_SPEC if enc == "abs"}
NARROW_REL = {f: (_DTYPES[w], _DTYPES[n], enc.split(":", 1)[1])
              for f, w, n, enc, _b, _y in NARROW_SPEC if enc != "abs"}


def at_rest_dtype(field: str, dtype, narrow: bool) -> np.dtype:
    """The dtype a snapshot stores `field` in."""
    spec = NARROW_ABS.get(field) or NARROW_REL.get(field)
    return np.dtype(spec[1] if narrow and spec else dtype)


def narrow_arrays(arrs: dict) -> dict:
    """Wide numpy Hosts arrays -> the narrow at-rest layout (the
    reference's ``narrow_state`` on the host)."""
    a = dict(arrs)
    for f, (_w, ndt, anchor) in NARROW_REL.items():
        s = arrs[f]
        a[f] = np.where(s >= 0, s - arrs[anchor][..., None],
                        np.array(-1, s.dtype)).astype(ndt)
    for f, (_w, ndt) in NARROW_ABS.items():
        a[f] = arrs[f].astype(ndt)
    return a


def widen_arrays(arrs: dict) -> dict:
    """Narrow numpy Hosts arrays -> the wide layout (the reference's
    ``widen_state``); identity on wide arrays. The abs columns widen
    first: they anchor the scoreboards."""
    a = dict(arrs)
    for f, (wdt, _n) in NARROW_ABS.items():
        a[f] = arrs[f].astype(wdt)
    for f, (wdt, _n, anchor) in NARROW_REL.items():
        rel = arrs[f]
        if rel.dtype != np.dtype(wdt):
            a[f] = np.where(rel >= 0, rel.astype(wdt) + a[anchor][..., None],
                            np.array(-1, wdt))
    return a


@dataclass
class Hosts:
    """All mutable per-host state. Every tensor has leading dim H."""
    # --- event queue (the per-host scheduler) ---
    eq_time: torch.Tensor   # [H, Q] i64, SIMTIME_MAX = free slot
    eq_seq: torch.Tensor    # [H, Q] i32 tie-break
    eq_kind: torch.Tensor   # [H, Q] i32
    eq_pkt: torch.Tensor    # [H, Q, PKT_WORDS] i32 payload
    eq_ctr: torch.Tensor    # [H] i32 next sequence number
    eq_next: torch.Tensor   # [H] i64 cached min(eq_time, dim=1)
    rng_ctr: torch.Tensor   # [H] i32 per-host RNG use counter
    cpu_avail: torch.Tensor  # [H] i64 CPU model busy horizon
    nic_busy: torch.Tensor      # [H] i64 tx free at this time
    nic_sched: torch.Tensor     # [H] bool an EV_NIC_TX is in flight
    nic_rr: torch.Tensor        # [H] i32 round-robin pointer
    nic_rx_until: torch.Tensor  # [H] i64 rx engine busy horizon
    txq_pkt: torch.Tensor       # [H, T, PKT_WORDS] i32 transmit ring
    txq_head: torch.Tensor      # [H] i32
    txq_cnt: torch.Tensor       # [H] i32
    pkt_ctr: torch.Tensor       # [H] i32 packets originated (loss uid)
    next_eport: torch.Tensor    # [H] i32 ephemeral port cursor
    # --- socket table [H, S] ---
    sk_used: torch.Tensor     # bool
    sk_proto: torch.Tensor    # i32
    sk_state: torch.Tensor    # i32
    sk_lport: torch.Tensor    # i32
    sk_rport: torch.Tensor    # i32
    sk_rhost: torch.Tensor    # i32
    sk_parent: torch.Tensor   # i32
    sk_snd_una: torch.Tensor  # i64
    sk_snd_nxt: torch.Tensor  # i64
    sk_snd_max: torch.Tensor  # i64
    sk_snd_end: torch.Tensor  # i64
    sk_rcv_nxt: torch.Tensor  # i64
    sk_ooo_s: torch.Tensor    # [H, S, K] i64
    sk_ooo_e: torch.Tensor    # [H, S, K] i64
    sk_sack_s: torch.Tensor   # [H, S, K] i64
    sk_sack_e: torch.Tensor   # [H, S, K] i64
    sk_hole_end: torch.Tensor  # i64
    sk_rex_nxt: torch.Tensor   # i64
    sk_peer_fin: torch.Tensor  # i64
    sk_fin_acked: torch.Tensor    # bool
    sk_close_after: torch.Tensor  # bool
    sk_cwnd: torch.Tensor     # f32
    sk_ssthresh: torch.Tensor  # f32
    sk_srtt: torch.Tensor     # i64
    sk_rtt_min: torch.Tensor  # i64
    sk_rttvar: torch.Tensor   # i64
    sk_rto: torch.Tensor      # i64
    sk_rto_deadline: torch.Tensor  # i64
    sk_timer_on: torch.Tensor   # bool
    sk_timer_gen: torch.Tensor  # i32
    sk_dupacks: torch.Tensor  # i32
    sk_rtt_seq: torch.Tensor  # i64
    sk_rtt_time: torch.Tensor  # i64
    sk_ctl: torch.Tensor      # i32
    sk_peer_rwnd: torch.Tensor  # i64
    sk_sndbuf: torch.Tensor   # i64
    sk_rcvbuf: torch.Tensor   # i64
    sk_hs_time: torch.Tensor  # i64
    sk_last_tx: torch.Tensor  # i64
    sk_syn_tag: torch.Tensor  # i32
    sk_proc: torch.Tensor     # i32
    sk_app_ref: torch.Tensor  # i32
    sk_cc_wmax: torch.Tensor   # f32
    sk_cc_epoch: torch.Tensor  # i64
    sk_cc_k: torch.Tensor      # f32
    # --- app layer (one row per process slot) ---
    app_node: torch.Tensor  # [H, PP] i32
    app_r: torch.Tensor     # [H, PP, 8] i64 app registers
    app_proc: torch.Tensor  # [H] i32 process context during a dispatch
    tgen_sync: torch.Tensor  # [H, SY] i32
    # --- outbox: packets emitted this window awaiting exchange ---
    ob_pkt: torch.Tensor    # [H, O, PKT_WORDS] i32
    ob_time: torch.Tensor   # [H, O] i64 send (wire-entry) time
    ob_cnt: torch.Tensor    # [H] i32
    ob_next: torch.Tensor   # [H] i64 earliest arrival among carried packets
    # --- hosted-app wake ring ---
    hw_time: torch.Tensor   # [H, HW] i64
    hw_pkt: torch.Tensor    # [H, HW, PKT_WORDS] i32
    hw_cnt: torch.Tensor    # [H] i32
    hw_drop: torch.Tensor   # [H] i32
    # --- packet-trace ring ---
    tr_time: torch.Tensor   # [H, TC] i64
    tr_pkt: torch.Tensor    # [H, TC, PKT_WORDS] i32
    tr_dir: torch.Tensor    # [H, TC] i32
    tr_cnt: torch.Tensor    # [H] i32
    tr_drop: torch.Tensor   # [H] i32
    # --- observability ---
    stats: torch.Tensor     # [H, N_STATS] i64
    ns_hist: torch.Tensor   # [H, NS_KINDS, 0] i64 (netscope off)
    cap_peaks: torch.Tensor  # [H, 4] i32 peak occupancy

    def numpy(self) -> dict:
        """{field: numpy array} host copy, in declaration order."""
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in fields(self)}


@dataclass
class HostParams:
    """Read-only per-host configuration, leading dim H."""
    hid: torch.Tensor        # [H] i32
    rng_stream: torch.Tensor  # [H] u32 per-host PRNG stream
    vertex: torch.Tensor     # [H] i32 topology attachment
    bw_up: torch.Tensor      # [H] i64 bytes/sec
    bw_down: torch.Tensor    # [H] i64
    app_kind: torch.Tensor   # [H, PP] i32
    app_cfg: torch.Tensor    # [H, PP, 8] i64
    nic_buf: torch.Tensor    # [H] i64 NIC input buffer bytes
    cpu_cost: torch.Tensor   # [H] i64
    cpu_threshold: torch.Tensor  # [H] i64
    rcvbuf0: torch.Tensor    # [H] i64
    sndbuf0: torch.Tensor    # [H] i64
    pcap_on: torch.Tensor    # [H] bool


@dataclass
class Shared:
    """Replicated loop-invariant tables and scalars."""
    lanes = 1       # one scenario (LaneShared stacks several)
    lat_ns: torch.Tensor      # [V, V] i64 path latency
    rel: torch.Tensor         # [V, V] f32 path reliability
    host_vertex: torch.Tensor  # [H] i32
    host_bw_up: torch.Tensor   # [H] i64
    host_bw_down: torch.Tensor  # [H] i64
    rng_root: torch.Tensor    # [2] u32 threefry key of the seed (setup only)
    seed32: torch.Tensor      # u32 scalar: root of the counter PRNG
    stop_time: torch.Tensor   # i64 scalar
    min_jump: torch.Tensor    # i64 scalar: lookahead window width
    cc_kind: torch.Tensor      # i32
    tcp_init_wnd: torch.Tensor  # f32
    tcp_ssthresh0: torch.Tensor  # f32
    tgen_nodes: torch.Tensor   # [N, 10] i64 tgen behavior-graph nodes
    tgen_peers: torch.Tensor   # [NP, 2] i32 (host, port) transfer peers
    tgen_pool: torch.Tensor    # [NS] i64 drawn pause choices (ns)
    tgen_edges: torch.Tensor   # [NE] i32 successor-node indices


def alloc_hosts(cfg: EngineConfig, device) -> Hosts:
    H, Q, S, O = cfg.num_hosts, cfg.qcap, cfg.scap, cfg.obcap
    T = cfg.txqcap
    i32, i64, f32, b = torch.int32, torch.int64, torch.float32, torch.bool

    def full(shape, val, dt):
        return torch.full(shape, val, dtype=dt, device=device)

    PP = max(cfg.procs_per_host, 1)
    HW = max(cfg.hostedcap, 1)
    TC = max(cfg.tracecap, 1)
    return Hosts(
        eq_time=full((H, Q), SIMTIME_MAX, i64),
        eq_seq=full((H, Q), 0, i32),
        eq_kind=full((H, Q), 0, i32),
        eq_pkt=full((H, Q, PKT_WORDS), 0, i32),
        eq_ctr=full((H,), 0, i32),
        eq_next=full((H,), SIMTIME_MAX, i64),
        rng_ctr=full((H,), 0, i32),
        cpu_avail=full((H,), 0, i64),
        nic_busy=full((H,), 0, i64),
        nic_sched=full((H,), False, b),
        nic_rr=full((H,), 0, i32),
        nic_rx_until=full((H,), 0, i64),
        txq_pkt=full((H, T, PKT_WORDS), 0, i32),
        txq_head=full((H,), 0, i32),
        txq_cnt=full((H,), 0, i32),
        pkt_ctr=full((H,), 0, i32),
        next_eport=full((H,), C.MIN_RANDOM_PORT, i32),
        sk_used=full((H, S), False, b),
        sk_proto=full((H, S), 0, i32),
        sk_state=full((H, S), 0, i32),
        sk_lport=full((H, S), 0, i32),
        sk_rport=full((H, S), 0, i32),
        sk_rhost=full((H, S), -1, i32),
        sk_parent=full((H, S), -1, i32),
        sk_snd_una=full((H, S), 0, i64),
        sk_snd_nxt=full((H, S), 0, i64),
        sk_snd_max=full((H, S), 0, i64),
        sk_snd_end=full((H, S), 0, i64),
        sk_rcv_nxt=full((H, S), 0, i64),
        sk_ooo_s=full((H, S, SACK_K), -1, i64),
        sk_ooo_e=full((H, S, SACK_K), -1, i64),
        sk_sack_s=full((H, S, SACK_K), -1, i64),
        sk_sack_e=full((H, S, SACK_K), -1, i64),
        sk_hole_end=full((H, S), 0, i64),
        sk_rex_nxt=full((H, S), 0, i64),
        sk_peer_fin=full((H, S), -1, i64),
        sk_fin_acked=full((H, S), False, b),
        sk_close_after=full((H, S), False, b),
        sk_cwnd=full((H, S), 0.0, f32),
        sk_ssthresh=full((H, S), 0.0, f32),
        sk_srtt=full((H, S), -1, i64),
        sk_rtt_min=full((H, S), -1, i64),
        sk_rttvar=full((H, S), 0, i64),
        sk_rto=full((H, S), C.TCP_RTO_INIT, i64),
        sk_rto_deadline=full((H, S), 0, i64),
        sk_timer_on=full((H, S), False, b),
        sk_timer_gen=full((H, S), 0, i32),
        sk_dupacks=full((H, S), 0, i32),
        sk_rtt_seq=full((H, S), -1, i64),
        sk_rtt_time=full((H, S), 0, i64),
        sk_ctl=full((H, S), 0, i32),
        sk_peer_rwnd=full((H, S), C.RECV_BUFFER_SIZE, i64),
        sk_sndbuf=full((H, S), C.SEND_BUFFER_SIZE, i64),
        sk_rcvbuf=full((H, S), C.RECV_BUFFER_SIZE, i64),
        sk_hs_time=full((H, S), 0, i64),
        sk_last_tx=full((H, S), 0, i64),
        sk_syn_tag=full((H, S), 0, i32),
        sk_proc=full((H, S), 0, i32),
        sk_app_ref=full((H, S), -1, i32),
        sk_cc_wmax=full((H, S), 0.0, f32),
        sk_cc_epoch=full((H, S), -1, i64),
        sk_cc_k=full((H, S), 0.0, f32),
        app_node=full((H, PP), 0, i32),
        app_r=full((H, PP, 8), 0, i64),
        app_proc=full((H,), 0, i32),
        tgen_sync=full((H, max(cfg.synccap, 1)), 0, i32),
        ob_pkt=full((H, O, PKT_WORDS), 0, i32),
        ob_time=full((H, O), 0, i64),
        ob_cnt=full((H,), 0, i32),
        ob_next=full((H,), SIMTIME_MAX, i64),
        hw_time=full((H, HW), 0, i64),
        hw_pkt=full((H, HW, PKT_WORDS), 0, i32),
        hw_cnt=full((H,), 0, i32),
        hw_drop=full((H,), 0, i32),
        tr_time=full((H, TC), 0, i64),
        tr_pkt=full((H, TC, PKT_WORDS), 0, i32),
        tr_dir=full((H, TC), 0, i32),
        tr_cnt=full((H,), 0, i32),
        tr_drop=full((H,), 0, i32),
        stats=full((H, N_STATS), 0, i64),
        ns_hist=full((H, NS_KINDS, NS_BUCKETS if cfg.netscope else 0), 0,
                     i64),
        cap_peaks=full((H, 4), 0, i32),
    )


def shape_census(cfg: EngineConfig) -> dict:
    """{field: (shape, dtype name)} of every Hosts column at this
    config, from ``alloc_hosts`` on the meta device (no memory): the
    counterpart of the reference's ``shape_census``. The device state
    is wide, whatever ``cfg.wide_state`` says."""
    h = alloc_hosts(cfg, "meta")
    return {f.name: (tuple(int(d) for d in getattr(h, f.name).shape),
                     str(getattr(h, f.name).dtype).replace("torch.", ""))
            for f in fields(h)}


def make_shared(topo_lat_ns: np.ndarray, topo_rel: np.ndarray,
                stop_time: int, min_jump: int, device, seed: int = 1,
                cc_kind: int = 2, tcp_init_wnd: float = 10.0,
                tcp_ssthresh0: float = 0.0, tgen_nodes: np.ndarray = None,
                tgen_peers: np.ndarray = None, tgen_pool: np.ndarray = None,
                tgen_edges: np.ndarray = None,
                host_vertex: np.ndarray = None,
                host_bw_up: np.ndarray = None,
                host_bw_down: np.ndarray = None) -> Shared:
    """The replicated tables on `device`; the tgen tables default to the
    reference's one-row placeholders (no behavior graph)."""
    if host_vertex is None:
        host_vertex = np.zeros((1,), np.int32)
    if host_bw_up is None:
        host_bw_up = np.ones((1,), np.int64)
    if host_bw_down is None:
        host_bw_down = np.ones((1,), np.int64)
    if tgen_nodes is None:
        tgen_nodes = np.zeros((1, 10), np.int64)
    if tgen_peers is None:
        tgen_peers = np.zeros((1, 2), np.int32)
    if tgen_pool is None:
        tgen_pool = np.zeros((1,), np.int64)
    if tgen_edges is None:
        tgen_edges = np.full((1,), -1, np.int32)

    def t(a, dt):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    # jax.random.PRNGKey(seed) for the default threefry impl: [hi, lo]
    root = [(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF]
    return Shared(
        lat_ns=t(topo_lat_ns, torch.int64),
        rel=t(topo_rel, torch.float32),
        host_vertex=t(host_vertex, torch.int32),
        host_bw_up=t(host_bw_up, torch.int64),
        host_bw_down=t(host_bw_down, torch.int64),
        rng_root=torch.tensor(root, dtype=torch.int64,
                              device=device).to(torch.uint32),
        seed32=torch.tensor(seed & 0xFFFFFFFF, dtype=torch.int64,
                            device=device).to(torch.uint32),
        stop_time=t(stop_time, torch.int64),
        min_jump=t(min_jump, torch.int64),
        cc_kind=t(cc_kind, torch.int32),
        tcp_init_wnd=t(tcp_init_wnd, torch.float32),
        tcp_ssthresh0=t(tcp_ssthresh0, torch.float32),
        tgen_nodes=t(tgen_nodes, torch.int64),
        tgen_peers=t(tgen_peers, torch.int32),
        tgen_pool=t(tgen_pool, torch.int64),
        tgen_edges=t(tgen_edges, torch.int32),
    )


# --- Lanes: same-shape scenarios stacked along the row axis -----------------
#
# B scenarios that share one EngineConfig and array shapes run as one
# state of B*H rows, row b*H + h holding host h of lane b: one drain
# pass steps every lane (engine.window.run_windows_batch). Host ids, the
# packet words and the PRNG streams stay lane-local; what the engine
# reads from Shared becomes per lane or per row (LaneShared).


@dataclass
class LaneShared:
    """Shared of B stacked lanes (the engine reads the same names).
    Scalars are [B] per lane; the per-host and TCP values are [B*H]
    per row; the topology tables are [B, V, V]; each tgen table is the
    lanes' tables one after another, read through ``tgen_base`` (row
    -> offset of its lane's copy)."""
    lanes: int
    hosts: int
    lat_ns: torch.Tensor        # [B, V, V] i64
    rel: torch.Tensor           # [B, V, V] f32
    host_vertex: torch.Tensor   # [B*H] i32
    host_bw_up: torch.Tensor    # [B*H] i64
    host_bw_down: torch.Tensor  # [B*H] i64
    seed32: torch.Tensor        # [B] u32
    drop_base: torch.Tensor     # [B] i64 loss-roll stream base of each seed
    stop_time: torch.Tensor     # [B] i64
    min_jump: torch.Tensor      # [B] i64
    cc_kind: torch.Tensor       # [B*H] i32
    tcp_init_wnd: torch.Tensor  # [B*H] f32
    tcp_ssthresh0: torch.Tensor  # [B*H] f32
    tgen_nodes: torch.Tensor    # [B*N, 10] i64
    tgen_peers: torch.Tensor    # [B*NP, 2] i32
    tgen_pool: torch.Tensor     # [B*NS] i64
    tgen_edges: torch.Tensor    # [B*NE] i32
    tgen_base: dict             # table name -> [B*H] i64 row offset


def stack_rows(trees: list):
    """Hosts or HostParams of B lanes -> one of B*H rows (copies)."""
    cls = type(trees[0])
    return cls(**{f.name: torch.cat([getattr(t, f.name) for t in trees])
                  for f in fields(cls)})


def lane_rows(tree, b: int, H: int):
    """Rows [b*H, (b+1)*H) of a stacked Hosts or HostParams, as views."""
    cls = type(tree)
    return cls(**{f.name: getattr(tree, f.name)[b * H:(b + 1) * H]
                  for f in fields(cls)})


def stack_shared(shs: list, H: int) -> LaneShared:
    """The Shared of B lanes (same shapes) as one LaneShared."""
    from ..core import rng as R
    B = len(shs)
    dev = shs[0].lat_ns.device

    def rows(name):
        # a scalar per lane, repeated over its H rows
        return torch.stack([getattr(s, name) for s in shs]
                           ).repeat_interleave(H)

    def cat(name):
        return torch.cat([getattr(s, name) for s in shs])

    def base(name):
        n = getattr(shs[0], name).shape[0]
        return (torch.arange(B, dtype=torch.int64, device=dev) * n
                ).repeat_interleave(H)

    seeds = [int(s.seed32) for s in shs]
    tg = ("tgen_nodes", "tgen_peers", "tgen_pool", "tgen_edges")
    return LaneShared(
        lanes=B, hosts=H,
        lat_ns=torch.stack([s.lat_ns for s in shs]),
        rel=torch.stack([s.rel for s in shs]),
        host_vertex=cat("host_vertex"),
        host_bw_up=cat("host_bw_up"),
        host_bw_down=cat("host_bw_down"),
        seed32=torch.stack([s.seed32 for s in shs]),
        drop_base=torch.tensor([R.stream_base(sd, R.DOMAIN_DROP)
                                for sd in seeds], dtype=torch.int64,
                               device=dev),
        stop_time=torch.stack([s.stop_time for s in shs]),
        min_jump=torch.stack([s.min_jump for s in shs]),
        cc_kind=rows("cc_kind"),
        tcp_init_wnd=rows("tcp_init_wnd"),
        tcp_ssthresh0=rows("tcp_ssthresh0"),
        **{name: cat(name) for name in tg},
        tgen_base={name: base(name) for name in tg},
    )
