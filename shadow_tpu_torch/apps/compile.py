"""Compile scenario process specs into per-host app wiring.

Counterpart of ``shadow_tpu/apps/compile.py``; the capacity planner
(``peak_sockets``/``auto_caps``) is copied whole, because queue and
outbox capacities change results. Shadow launches real plugin binaries
with an argv string (shd-configuration.h process element); the app
tier instead maps each plugin id to a vectorized app kind plus eight
int64 config words (HostParams.app_cfg). Arguments use `key=value` pairs; hostnames
resolve through the virtual DNS.

Plugins:
  ping        peer=<host> port=N interval=<time> size=BYTES count=N
  pingserver  port=N
  phold       port=N mean=<time> size=BYTES init=N
  gossip      port=N fanout=N interval=<time> miner=0|1 size=BYTES n=N
  bulk        peer=<host> port=N size=BYTES count=N pause=<time>
  bulkserver  port=N
  socksclient proxy-lo=ID proxy-hi=ID proxy-port=N server-lo=ID
              server-hi=ID size=BYTES count=N pause=<time> hops=1..3
  socksproxy  port=N server-port=N relay-lo=ID relay-hi=ID
  tgen        <behavior graphml path, or the graphml inline>
  hosted:<name> <the app's own argument string> (hosting/: a HostedApp
              registered under <name>, a C plugin, or ``shim`` for an
              unmodified binary behind the LD_PRELOAD shim)
"""

from __future__ import annotations

import os

import numpy as np

from ..core.simtime import parse_time
from .base import (APP_BULK, APP_BULK_SERVER, APP_GOSSIP, APP_HOSTED,
                   APP_PHOLD, APP_PING, APP_PING_SERVER, APP_SOCKS_CLIENT,
                   APP_SOCKS_PROXY, APP_TGEN)


def parse_kv(args: str) -> dict:
    out = {}
    for tok in args.split():
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k] = v
        else:
            out.setdefault("_positional", []).append(tok)
    return out


def compile_app(plugin: str, args: str, dns, num_hosts: int,
                tgen_tables=None):
    """-> (app_kind, cfg[8] int64) for one process spec. A tgen
    process compiles its behavior graph into `tgen_tables`
    (apps/tgen.TgenTables, one per simulation)."""
    cfg = np.zeros(8, dtype=np.int64)
    kv = parse_kv(args)
    if plugin == "ping":
        cfg[0] = dns.resolve(kv["peer"])
        cfg[1] = int(kv.get("port", 8000))
        cfg[2] = parse_time(kv.get("interval", "1s"))
        cfg[3] = int(kv.get("size", 64))
        cfg[4] = int(kv.get("count", 0))
        return APP_PING, cfg
    if plugin == "pingserver":
        cfg[1] = int(kv.get("port", 8000))
        return APP_PING_SERVER, cfg
    if plugin == "phold":
        cfg[0] = num_hosts
        cfg[1] = int(kv.get("port", 8000))
        cfg[2] = parse_time(kv.get("mean", "100ms"))
        cfg[3] = int(kv.get("size", 64))
        cfg[4] = int(kv.get("init", 1))
        return APP_PHOLD, cfg
    if plugin == "gossip":
        # block-gossip / Bitcoin-style tip propagation (apps/gossip.py).
        # `n` bounds the peer id range for relay draws; it defaults to
        # the whole scenario.
        cfg[0] = int(kv.get("n", num_hosts))
        cfg[1] = int(kv.get("port", 8333))
        cfg[2] = int(kv.get("fanout", 8))
        cfg[3] = parse_time(kv.get("interval", "10s"))
        cfg[4] = int(kv.get("miner", 0))
        cfg[5] = int(kv.get("size", 500))
        return APP_GOSSIP, cfg
    if plugin == "bulk":
        cfg[0] = dns.resolve(kv["peer"])
        cfg[1] = int(kv.get("port", 80))
        cfg[2] = int(kv.get("size", 1 << 20))
        cfg[3] = int(kv.get("count", 1))
        cfg[4] = parse_time(kv.get("pause", "1s"))
        return APP_BULK, cfg
    if plugin == "bulkserver":
        cfg[1] = int(kv.get("port", 80))
        return APP_BULK_SERVER, cfg
    if plugin == "socksclient":
        # host-id ranges name the relay and server pools (hosts are
        # id-ordered by their declaration order in the scenario)
        cfg[0] = int(kv["proxy-lo"])
        cfg[1] = int(kv["proxy-hi"])
        cfg[2] = int(kv.get("proxy-port", 9050))
        cfg[3] = int(kv["server-lo"])
        cfg[4] = int(kv["server-hi"])
        if cfg[4] - 1 > 0xFFFFF:
            raise ValueError(
                "socksclient server host ids exceed the 20-bit "
                "CONNECT-tag field (max id 1048575)")
        # sizes round UP to the tag's 4 KiB units (never under-deliver)
        size_u4k = max(1, (int(kv.get("size", 51200)) + 4095) >> 12)
        if size_u4k > 0x1FF:
            raise ValueError(
                f"socksclient size {kv.get('size')} exceeds the "
                "~2 MiB per-fetch limit of the tag encoding")
        cfg[5] = size_u4k
        cfg[6] = int(kv.get("count", 0))
        hops = int(kv.get("hops", 1))
        if not 1 <= hops <= 3:
            raise ValueError("socksclient hops must be 1-3 "
                             "(relays per circuit)")
        cfg[7] = parse_time(kv.get("pause", "1s")) | (hops << 56)
        return APP_SOCKS_CLIENT, cfg
    if plugin == "socksproxy":
        # chain extension dials the next relay on THIS relay's port=,
        # so every relay in one pool must listen on the same port
        cfg[1] = int(kv.get("port", 9050))
        cfg[2] = int(kv.get("server-port", 80))
        cfg[3] = int(kv.get("relay-lo", 0))
        cfg[4] = int(kv.get("relay-hi", 0))
        return APP_SOCKS_PROXY, cfg
    if plugin.startswith("hosted:"):
        # CPU-hosted app code (hosting/): the Simulation builds a
        # HostingRuntime instance per such host; on the device it is
        # only the wake-ring app kind
        return APP_HOSTED, cfg
    if plugin == "tgen":
        if tgen_tables is None:
            raise ValueError("tgen requires a TgenTables compile context")
        source = args.strip()
        if not source.startswith("<"):
            # a file path (the reference's argv form), relative to the
            # working directory; taken whole, not split as key=value
            if not source:
                raise ValueError(
                    "tgen requires a behavior graph (a graphml path or "
                    "inline graphml) as its process argument")
            if not os.path.exists(source):
                raise ValueError(
                    f"tgen behavior graph not found: {source!r}")
        cfg[0] = tgen_tables.compile(source, dns)
        return APP_TGEN, cfg
    raise ValueError(f"unknown plugin {plugin!r} (ported: ping, "
                     "pingserver, phold, gossip, bulk, bulkserver, "
                     "socksclient, socksproxy, tgen)")


# --- scenario-scaled engine capacities (shrink campaign, lever 3) ---------
#
# Every socket-table row costs ~239 B/host-slot at the narrow layout
# (~364 wide) whether or not a socket ever lives there, and qcap rides
# on scap (one standing RTO timer per live socket). The hand-tuned
# per-config caps in tools/baseline_configs are sized for the WORST
# member of a config family; most scenarios declare enough in their
# process specs to size exactly. peak_sockets() reads those
# declarations; auto_caps() turns them into an EngineConfig with a 2x
# margin. Overflow above a cap defers to the next window (exact), so a
# mis-declared peak costs windows, never correctness.

def _tgen_attr(graphml: str, attr: str):
    """First <data> value for a graphml attr.name, resolving the
    attr -> key-id indirection (<key attr.name=.. id=..>)."""
    import re
    m = re.search(r'<key[^>]*attr\.name="%s"[^>]*id="([^"]+)"' % attr,
                  graphml)
    if not m:
        m = re.search(r'<key[^>]*id="([^"]+)"[^>]*attr\.name="%s"' % attr,
                      graphml)
    if not m:
        return None
    d = re.search(r'<data key="%s">([^<]*)</data>' % re.escape(m.group(1)),
                  graphml)
    return d.group(1) if d else None


def _strip_ordinal(name: str) -> str:
    """'relay37' -> 'relay' — hostnames are spec id + 1-based ordinal
    (core.dns expansion order)."""
    return name.rstrip("0123456789") or name


def peak_sockets(scenario):
    """Per-HostSpec peak concurrent sockets, from the apps' declared
    traffic shape -> {spec_id: peak} — or None with a reason string,
    (None, why), when any process is unbounded (hosted apps, unknown
    plugins, tgen file-path graphs the planner cannot read inline).

    The model: each plugin contributes sockets it OWNS on its host
    (listeners, the one in-flight fetch) plus LOAD it lands on remote
    pools, distributed uniformly over the pool — a socks circuit
    crosses each of its `hops` relays with 2 sockets (in + out leg,
    apps/socks.py), a fetch holds 1 server-side socket."""
    specs = []          # (spec, id_lo, id_hi)
    lo = 0
    for hs in scenario.hosts:
        q = max(int(hs.quantity or 1), 1)
        specs.append((hs, lo, lo + q))
        lo += q

    own = {hs.id: 0 for hs, _, _ in specs}      # per-host owned peak
    loads = []                                  # (id_lo, id_hi, total)
    named_loads = []                            # (spec_id, n_pool, total)

    for hs, s_lo, s_hi in specs:
        q = s_hi - s_lo
        for ps in hs.processes:
            kv = parse_kv(ps.arguments)
            p = ps.plugin
            if p in ("ping", "pingserver", "phold", "gossip",
                     "bulkserver", "socksproxy"):
                own[hs.id] += 1                 # one UDP sock / listener
            elif p == "bulk":
                own[hs.id] += 1                 # serial fetches
                peer = _strip_ordinal(kv["peer"])
                named_loads.append((peer, 1, q))
            elif p == "socksclient":
                own[hs.id] += 1                 # one circuit leg at a time
                hops = int(kv.get("hops", 1))
                rlo, rhi = int(kv["proxy-lo"]), int(kv["proxy-hi"])
                slo, shi = int(kv["server-lo"]), int(kv["server-hi"])
                # 2 sockets on every relay the circuit crosses, 1 on
                # the server; pools absorb the whole client population
                loads.append((rlo, rhi, 2 * hops * q))
                loads.append((slo, shi, 1 * q))
            elif p == "tgen":
                src = ps.arguments.strip()
                if not src.startswith("<"):
                    return None, (f"spec {hs.id!r}: tgen file-path "
                                  "graph — peak not declared inline")
                peers = _tgen_attr(src, "peers")
                if peers:
                    own[hs.id] += 2             # active transfer + churn
                    names = [t.split(":")[0] for t in peers.split(",")
                             if t.strip()]
                    by_spec = {}
                    for nm in names:
                        by_spec[_strip_ordinal(nm)] = \
                            by_spec.get(_strip_ordinal(nm), 0) + 1
                    for spec_id, n_pool in by_spec.items():
                        named_loads.append(
                            (spec_id, n_pool,
                             q * n_pool / max(len(names), 1)))
                else:
                    own[hs.id] += 1             # pure server graph
            else:
                return None, (f"spec {hs.id!r}: plugin {p!r} declares "
                              "no socket peak (hosted/unknown)")

    peaks = {}
    for hs, s_lo, s_hi in specs:
        density = 0.0
        for l_lo, l_hi, total in loads:
            o_lo, o_hi = max(s_lo, l_lo), min(s_hi, l_hi)
            if o_hi > o_lo and l_hi > l_lo:
                density += total / (l_hi - l_lo)
        for spec_id, n_pool, total in named_loads:
            if spec_id == hs.id:
                density += total / max(n_pool, 1)
        peaks[hs.id] = own[hs.id] + int(-(-density // 1))
    return peaks, None


def auto_caps(scenario, base):
    """Scenario-scaled capacities: (EngineConfig, info dict).

    scap = ceil16(2 x max declared peak) — the 2x absorbs TIME_WAIT
    residue and burst skew above the mean the peak model computes.
    qcap preserves the BASE's qcap - scap headroom delta, not a ratio:
    the delta is the arrival budget that keeps one standing RTO-timer
    event per live socket from starving intake
    (tools/baseline_configs.socks_caps round-3 notes). obcap/txqcap
    are per-window throughput budgets, not per-socket needs — they
    keep the base value, clamped to scap (budgeting more emit slots
    than sockets that could emit buys nothing).

    When the scenario declares no computable peak the BASE caps come
    back unchanged with info["applied"] False — the planner never
    guesses."""
    import dataclasses

    peaks, why = peak_sockets(scenario)
    if peaks is None:
        return base, {"applied": False, "why": why}
    mx = max(peaks.values()) if peaks else 1
    scap = max(((2 * mx + 15) // 16) * 16, 16)
    qcap = scap + max(base.qcap - base.scap, 16)
    obcap = min(base.obcap, scap)
    txqcap = min(base.txqcap, scap)
    cfg = dataclasses.replace(base, scap=scap, qcap=qcap, obcap=obcap,
                              txqcap=txqcap)
    return cfg, {
        "applied": True, "peaks": peaks, "max_peak": mx,
        "caps": {"scap": scap, "qcap": qcap, "obcap": obcap,
                 "txqcap": txqcap},
        "base_caps": {"scap": base.scap, "qcap": base.qcap,
                      "obcap": base.obcap, "txqcap": base.txqcap},
        "grew": scap > base.scap,
    }
