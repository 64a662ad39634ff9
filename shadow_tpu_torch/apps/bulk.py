"""Bulk TCP transfer client/server — the tgen "bulk" workload shape.

Counterpart of ``shadow_tpu/apps/bulk.py``: each client repeatedly
opens a TCP connection to its server, writes a fixed number of bytes,
closes, pauses and repeats. The server also serves GET-tagged SYNs
(a request size in the SYN's APP word, the tgen-server convention), so
SOCKS configs can use it as their target.

Client config (app_cfg): c0=server host, c1=port, c2=bytes per
transfer, c3=transfer count (0 = forever), c4=pause ns.
Client registers: r0=socket, r1=transfers completed.
Server config: c1=listen port. Server registers: r0=listener slot.
"""

from __future__ import annotations

import torch

from ..core import flow as FL
from ..core.rowops import col_add, rget
from ..engine.defs import ST_APP_DONE, ST_XFER_DONE
from ..net import packet as P
from ..net.tcp import tcp_close_call, tcp_connect, tcp_listen, tcp_write
from ..obs import netscope
from .base import branch_of, cfg_words, regs, set_reg, timer


def _connect(st, hp, sh, m, now):
    c = cfg_words(hp)
    slot, _ok = tcp_connect(st, hp, sh, m, now, dst_host=c[:, 0],
                            dst_port=c[:, 1])
    set_reg(st, m, 0, slot.to(torch.int64))


def app_bulk(st, hp, sh, m, now, wake, br, plan):
    b = branch_of(wake)
    c = cfg_words(hp)
    sock = regs(st)[:, 0].to(torch.int32)

    @FL.when(FL.any_of(br[0], br[1]))       # WAKE_START, WAKE_TIMER
    def _():
        _connect(st, hp, sh, m & ((b == 0) | (b == 1)), now)

    @FL.when(br[3])                         # WAKE_CONNECTED
    def _():
        tcp_write(st, m & (b == 3), now, sock, c[:, 2])

    @FL.when(br[6])                         # WAKE_SENT: transfer done
    def _():
        ms = m & (b == 6)
        if netscope.on(st):
            # completion time runs from the handshake stamp, read
            # before the close path touches the slot
            dur_us = (now - rget(st.sk_hs_time, sock)).clamp(min=0) // 1000
            netscope.observe(st, ms, netscope.NS_COMPLETION, dur_us)
        tcp_close_call(st, ms, now, sock)
        set_reg(st, ms, 1, regs(st)[:, 1] + 1)
        col_add(st.stats, ST_XFER_DONE, ms)
        done = (c[:, 3] > 0) & (regs(st)[:, 1] >= c[:, 3])
        col_add(st.stats, ST_APP_DONE, ms & done)
        timer(st, ms & ~done, now + c[:, 4])


def app_bulk_server(st, hp, sh, m, now, wake, br, plan):
    b = branch_of(wake)
    slot = wake[:, P.SEQ]

    @FL.when(br[0])                         # WAKE_START: listen
    def _():
        ms = m & (b == 0)
        lslot, _ok = tcp_listen(st, ms, cfg_words(hp)[:, 1])
        set_reg(st, ms, 0, lslot.to(torch.int64))
    fresh = wake[:, P.WND] == rget(st.sk_timer_gen, slot)
    tag = rget(st.sk_syn_tag, slot)

    @FL.when(br[5])                         # WAKE_ACCEPT: serve a GET
    def _():
        size = (tag & ((1 << 30) - 1)).to(torch.int64)
        get = m & (b == 5) & fresh & ((tag & (1 << 30)) == 0) & (size > 0)
        tcp_write(st, get, now, slot, size)
        tcp_close_call(st, get, now, slot)

    @FL.when(br[4])                         # WAKE_EOF: a PUT finished
    def _():
        # EOFs on served-GET children are teardown noise (the fetcher
        # counts those); a recycled slot's tag belongs to its new owner
        served_get = (tag != 0) & ((tag & (1 << 30)) == 0)
        put = m & (b == 4) & fresh & ~served_get
        tcp_close_call(st, put, now, slot)
        col_add(st.stats, ST_XFER_DONE, put)
