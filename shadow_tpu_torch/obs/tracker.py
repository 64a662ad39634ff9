"""Heartbeat tracker: periodic per-host and global metrics.

Counterpart of ``shadow_tpu/obs/tracker.py``, line for line: the
reference Shadow's ``[shadow-heartbeat] [node|socket|ram|summary]``
lines, computed at window-chunk boundaries from the counters the engine
keeps anyway (``Hosts.stats``) and the socket table, read to the host
once per heartbeat.

- ``[node]``    per-host interval deltas of the engine counters;
- ``[socket]``  per-host, ``|``-joined per-socket segments
  ``slot,proto,peer:port;inbuflen,inbufsize,outbuflen,outbufsize;``
  ``recv-bytes,send-bytes`` (out fill = written-but-unacked bytes, in
  fill = out-of-order bytes held);
- ``[ram]``     per-host ``alloc,dealloc,total,sockets`` over the modeled
  buffered bytes, with a hosted child's resident set as ``rss=`` and
  the memory watermark as a trailing ``dev=``;
- ``[summary]`` the process's getrusage roll-up, with ``dev-peak-gib=``
  and ``waste=`` (the lockstep drain's wasted-lane share).

Stats are observable only at chunk boundaries, so when several
intervals elapse within one chunk the tracker emits ONE heartbeat at
the last elapsed boundary, covering the whole span (its interval column
carries the span). ``rss=``, ``dev=`` and ``waste=`` measure the
process; every other column of the [node], [socket] and [ram] lines
derives from simulation state alone.
"""

from __future__ import annotations

import resource

import numpy as np

from ..engine import defs
from . import metrics as _MT


HEADER = ("time,host,interval,events,pkts-sent,pkts-recv,bytes-sent,"
          "bytes-recv,retransmits,drop-net,drop-buf,transfers-done")


class Tracker:
    def __init__(self, interval_ns: int, host_names, logger=None):
        self.interval = int(interval_ns)
        self.names = list(host_names)
        self.logger = logger
        self.next_ns = self.interval
        self._prev = None
        self._prev_ram = None
        self.lines = []          # retained for tools/tests

    def _emit(self, line: str):
        self.lines.append(line)
        if _MT.ENABLED:
            _MT.REGISTRY.counter("tracker.lines").inc()
        if self.logger is not None:
            self.logger.message(self.next_ns, "tracker", line)

    def due(self, sim_ns: int) -> bool:
        """Will maybe_heartbeat emit anything at this time? Lets the
        caller skip fetching stats (a cross-process all-gather on a
        multi-process mesh) when no interval boundary has passed."""
        return self.interval > 0 and sim_ns >= self.next_ns

    def maybe_heartbeat(self, sim_ns: int, stats: np.ndarray,
                        socks: dict | None = None,
                        hosted_rss: dict | None = None,
                        dev_peak: int | None = None,
                        waste: float | None = None):
        """Called after each window chunk with current cumulative stats;
        emits one heartbeat covering all interval boundaries elapsed
        since the last call (see module docstring on sampling).

        socks: optional dict of per-socket numpy columns (sk_used,
        sk_proto, sk_rhost, sk_rport, sk_snd_una, sk_snd_end,
        sk_sndbuf, sk_rcv_nxt, sk_rcvbuf, ooo_held) enabling the
        [socket] and [ram] line families.

        hosted_rss: optional host_id -> resident-set bytes of the
        host's live hosted child (hosting.runtime.child_rss), a
        trailing ``rss=`` column of its [ram] line: real process
        memory beside the modeled buffer bytes.

        dev_peak: optional memory high-water bytes
        (obs.memscope.Watermark: the allocator peak on the card,
        process RSS on the CPU), a trailing ``dev=`` column of every
        [ram] line and ``dev-peak-gib=`` of the [summary] line.

        waste: optional cumulative wasted-lane share of the lockstep
        drain so far, the [summary] line's ``waste=`` column.
        """
        if self.interval <= 0 or sim_ns < self.next_ns:
            return
        # collapse all elapsed boundaries into one emission at the last
        elapsed = (sim_ns - self.next_ns) // self.interval + 1
        self.next_ns += (elapsed - 1) * self.interval
        # true covered span in seconds ("%g": sub-second intervals must
        # not truncate to 0 — consumers compute rates as delta/interval)
        span_s = f"{elapsed * self.interval / 1e9:g}"

        cur = stats.astype(np.int64)
        prev = (self._prev if self._prev is not None
                else np.zeros_like(cur))
        d = cur - prev
        self._prev = cur.copy()
        t = self.next_ns // 10**9

        for i, name in enumerate(self.names):
            if d[i, defs.ST_EVENTS] == 0:
                continue
            # the covered-span column keeps per-host rates
            # computable when several intervals collapse into one
            # chunk-boundary emission (rate = delta / interval)
            self._emit(
                f"[shadow-heartbeat] [node] {t},{name},{span_s},"
                f"{d[i, defs.ST_EVENTS]},"
                f"{d[i, defs.ST_PKTS_SENT]},"
                f"{d[i, defs.ST_PKTS_RECV]},"
                f"{d[i, defs.ST_BYTES_SENT]},"
                f"{d[i, defs.ST_BYTES_RECV]},"
                f"{d[i, defs.ST_RETRANSMIT]},"
                f"{d[i, defs.ST_PKTS_DROP_NET]},"
                f"{d[i, defs.ST_PKTS_DROP_BUF]},"
                f"{d[i, defs.ST_XFER_DONE]}")
        if socks is not None:
            self._heartbeat_sockets(t, span_s, socks, hosted_rss,
                                    dev_peak)

        ru = resource.getrusage(resource.RUSAGE_SELF)
        tot = d.sum(axis=0)
        # dev-peak-gib: the device-buffer watermark (obs.memscope) on
        # every summary heartbeat — scenarios whose hosts buffer
        # nothing (no [ram] lines) still report the measured high
        # water this way
        dev = (f"dev-peak-gib={dev_peak / (1 << 30):.3f},"
               if dev_peak else "")
        # waste=: cumulative lockstep lane waste — the
        # occupancy trend per heartbeat, same optional-column pattern
        # as dev-peak-gib
        wst = f"waste={waste:.4f}," if waste is not None else ""
        self._emit(
            f"[shadow-heartbeat] [summary] {t},"
            f"interval={span_s},"
            f"events={tot[defs.ST_EVENTS]},"
            f"pkts={tot[defs.ST_PKTS_SENT]}/{tot[defs.ST_PKTS_RECV]},"
            f"bytes={tot[defs.ST_BYTES_SENT]}/{tot[defs.ST_BYTES_RECV]},"
            f"{dev}{wst}"
            f"maxrss-gib={ru.ru_maxrss / (1 << 20):.3f},"
            f"utime-min={ru.ru_utime / 60:.3f},"
            f"stime-min={ru.ru_stime / 60:.3f}")
        if _MT.ENABLED:
            # heartbeats surface through the registry too: the metrics
            # snapshot shows how many fired and the interval-delta
            # totals without parsing the text lines
            reg = _MT.REGISTRY
            reg.counter("tracker.heartbeats").inc()
            reg.counter("tracker.events").inc(int(tot[defs.ST_EVENTS]))
            reg.gauge("tracker.last_sim_ns").set(int(self.next_ns))
        self.next_ns += self.interval

    def _heartbeat_sockets(self, t: int, span_s: str, socks: dict,
                           hosted_rss: dict | None = None,
                           dev_peak: int | None = None):
        used = socks["sk_used"]
        proto = socks["sk_proto"]
        is_tcp = proto == 6
        # buffer fill is a TCP notion here: UDP datagrams leave the
        # socket at txq-push (snd_una never advances for UDP, so
        # snd_end - snd_una would read as an ever-growing "leak")
        out_fill = np.where(
            is_tcp,
            np.maximum(socks["sk_snd_end"] - socks["sk_snd_una"], 0), 0)
        in_fill = socks["ooo_held"]
        # cumulative send-bytes: acked stream offset for TCP, datagram
        # bytes handed to the NIC for UDP
        sent_bytes = np.where(is_tcp, socks["sk_snd_una"],
                              socks["sk_snd_end"])
        # modeled RAM per host: all buffered bytes across sockets
        ram_total = (np.where(used, out_fill + in_fill, 0)).sum(axis=1)
        prev_ram = (self._prev_ram if self._prev_ram is not None
                    else np.zeros_like(ram_total))
        ram_delta = ram_total - prev_ram
        self._prev_ram = ram_total.copy()

        for i, name in enumerate(self.names):
            (slots,) = np.nonzero(used[i])
            if slots.size:
                segs = []
                for s in slots:
                    pname = "tcp" if proto[i, s] == 6 else "udp"
                    rh = int(socks["sk_rhost"][i, s])
                    peer = (f"{self.names[rh]}:{int(socks['sk_rport'][i, s])}"
                            if 0 <= rh < len(self.names) else "-:0")
                    segs.append(
                        f"{int(s)},{pname},{peer};"
                        f"{int(in_fill[i, s])},"
                        f"{int(socks['sk_rcvbuf'][i, s])},"
                        f"{int(out_fill[i, s])},"
                        f"{int(socks['sk_sndbuf'][i, s])};"
                        f"{int(socks['sk_rcv_nxt'][i, s])},"
                        f"{int(sent_bytes[i, s])}")
                self._emit(f"[shadow-heartbeat] [socket] {t},{name},"
                           + "|".join(segs))
            rss = (hosted_rss or {}).get(i)
            if ram_total[i] or ram_delta[i] or rss is not None:
                alloc = max(int(ram_delta[i]), 0)
                dealloc = max(-int(ram_delta[i]), 0)
                # rss= is the hosted child's real resident set, dev= the
                # memory watermark (obs.memscope): measured bytes beside
                # the modeled ones
                suffix = f",rss={int(rss)}" if rss is not None else ""
                if dev_peak:
                    suffix += f",dev={int(dev_peak)}"
                self._emit(
                    f"[shadow-heartbeat] [ram] {t},{name},"
                    f"{alloc},{dealloc},{int(ram_total[i])},"
                    f"{int(used[i].sum())}{suffix}")


def socket_columns(hosts) -> dict:
    """The tracker's per-socket columns of a port ``Hosts`` as numpy
    arrays (one transfer per heartbeat)."""
    ooo_s = hosts.sk_ooo_s.cpu().numpy()
    ooo_e = hosts.sk_ooo_e.cpu().numpy()
    ooo_held = np.maximum(np.where(ooo_s >= 0, ooo_e - ooo_s, 0),
                          0).sum(axis=-1)
    cols = ("sk_used", "sk_proto", "sk_rhost", "sk_rport", "sk_snd_una",
            "sk_snd_end", "sk_sndbuf", "sk_rcv_nxt", "sk_rcvbuf")
    out = {c: getattr(hosts, c).cpu().numpy() for c in cols}
    out["ooo_held"] = ooo_held
    return out
