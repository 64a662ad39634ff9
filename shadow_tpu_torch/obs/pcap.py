"""Pcap capture: drain the packet-trace rings into standard pcap files.

Counterpart of ``shadow_tpu/obs/pcap.py``, byte for byte. Packets are
recorded into each traced host's ring at the window exchange
(``engine.window._trace_append``: tx records for departing outbox
packets, rx records for merged arrivals) and drained per chunk; this
module synthesizes Ethernet/IPv4/TCP|UDP headers around the modeled
byte counts. Payloads are not materialized: each frame declares the
true original length with a header-only capture.

Loopback traffic never crosses the exchange and is not traced; capture
times are wire entry (tx) and arrival (rx).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..net import packet as P
from . import metrics as _MT

_GLOBAL_HDR = struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1)


def _mac(hid: int) -> bytes:
    return bytes([0x02, 0, (hid >> 24) & 0xFF, (hid >> 16) & 0xFF,
                  (hid >> 8) & 0xFF, hid & 0xFF])


def _frame(pkt_words, host_ips):
    """The synthesized headers of one trace record -> (frame bytes,
    original length)."""
    src, dst = int(pkt_words[P.SRC]), int(pkt_words[P.DST])
    proto = int(pkt_words[P.FLAGS]) & P.PROTO_MASK
    ln = int(pkt_words[P.LEN])
    sip = int(host_ips[src]) if 0 <= src < len(host_ips) else 0
    dip = int(host_ips[dst]) if 0 <= dst < len(host_ips) else 0

    eth = _mac(dst) + _mac(src) + b"\x08\x00"
    if proto == P.PROTO_TCP:
        l4len = 20 + ln
        flags = 0x10  # ACK
        w = int(pkt_words[P.FLAGS])
        if w & P.F_SYN:
            flags |= 0x02
        if w & P.F_FIN:
            flags |= 0x01
        if w & P.F_RST:
            flags |= 0x04
        l4 = struct.pack(
            ">HHIIBBHHH",
            int(pkt_words[P.SPORT]) & 0xFFFF,
            int(pkt_words[P.DPORT]) & 0xFFFF,
            int(pkt_words[P.SEQ]) & 0xFFFFFFFF,
            int(pkt_words[P.ACK]) & 0xFFFFFFFF,
            5 << 4, flags,
            int(pkt_words[P.WND]) & 0xFFFF, 0, 0)
        ipproto = 6
    else:
        l4len = 8 + ln
        l4 = struct.pack(">HHHH",
                         int(pkt_words[P.SPORT]) & 0xFFFF,
                         int(pkt_words[P.DPORT]) & 0xFFFF,
                         l4len & 0xFFFF, 0)
        ipproto = 17
    ip = struct.pack(">BBHHHBBHII", 0x45, 0, 20 + l4len, 0, 0, 64,
                     ipproto, 0, sip, dip)
    return eth + ip + l4, 14 + 20 + l4len


class PcapWriter:
    """One capture session: a file per traced host
    ("<name>-eth0.pcap"), fed by drain() after each window chunk."""

    def __init__(self, directory: str, host_names, host_ips, pcap_hosts):
        os.makedirs(directory, exist_ok=True)
        self.host_ips = np.asarray(host_ips, dtype=np.int64)
        self.files = {}
        for hid in pcap_hosts:
            path = os.path.join(directory,
                                f"{host_names[hid]}-eth0.pcap")
            f = open(path, "wb")
            f.write(_GLOBAL_HDR)
            self.files[hid] = f

    def drain(self, tr_time, tr_pkt, tr_cnt):
        """Write each traced host's ring records in time order (numpy
        arrays; stable, so equal times keep ring order)."""
        written = 0
        for hid, f in self.files.items():
            n = int(tr_cnt[hid])
            if not n:
                continue
            written += n
            order = np.argsort(tr_time[hid, :n], kind="stable")
            for i in order:
                t = int(tr_time[hid, i])
                frame, orig_len = _frame(tr_pkt[hid, i], self.host_ips)
                f.write(struct.pack("<IIII", t // 10**9,
                                    (t % 10**9) // 1000,
                                    len(frame), orig_len))
                f.write(frame)
        if written and _MT.ENABLED:
            _MT.REGISTRY.counter("pcap.records").inc(written)

    def close(self):
        for f in self.files.values():
            f.close()
        self.files = {}
