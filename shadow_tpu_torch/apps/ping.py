"""Ping/echo over UDP: the minimum end-to-end workload.

Counterpart of ``shadow_tpu/apps/ping.py``.

Client config (app_cfg): c0=peer host id, c1=server port,
c2=interval ns, c3=payload bytes, c4=ping count (0 = until sim end).
Client registers: r0=socket, r1=sent, r2=received.
Server config: c1=listen port. Registers: r0=socket.

RTT samples accumulate into ST_RTT_SUM_US / ST_RTT_COUNT; the send
timestamp rides the datagram's AUX tag in microseconds (mod 2^31).
"""

from __future__ import annotations

import torch

from ..core import flow as FL
from ..core.rowops import col_add
from ..core.simtime import SIMTIME_ONE_MICROSECOND
from ..engine.defs import (ST_APP_DONE, ST_RTT_COUNT, ST_RTT_SUM_US,
                           ST_XFER_DONE, WAKE_START, WAKE_SOCKET)
from ..net import packet as P
from ..net.udp import udp_open, udp_sendto
from ..obs import netscope
from .base import branch_of, cfg_words, regs, set_reg, timer

_US_MOD = 2**31


def _us31(t_ns):
    return (t_ns // SIMTIME_ONE_MICROSECOND) % _US_MOD


def _send_ping(st, hp, m, now):
    """Send one ping and arm the next-send timer at a fixed interval."""
    c = cfg_words(hp)
    udp_sendto(st, hp, m, now, regs(st)[:, 0], dst_host=c[:, 0],
               dst_port=c[:, 1], nbytes=c[:, 3], aux=_us31(now))
    set_reg(st, m, 1, regs(st)[:, 1] + 1)
    limit = c[:, 4]
    more = (limit == 0) | (regs(st)[:, 1] < limit)
    timer(st, m & more, now + c[:, 2])


def app_ping(st, hp, sh, m, now, wake, br, plan):
    b = branch_of(wake)

    @FL.when(br[0])                         # WAKE_START
    def _():
        ms = m & (b == 0)
        slot, _ok = udp_open(st, ms)
        set_reg(st, ms, 0, slot.to(torch.int64))
        _send_ping(st, hp, ms, now)

    @FL.when(br[1])                         # WAKE_TIMER
    def _():
        _send_ping(st, hp, m & (b == 1), now)

    @FL.when(br[2])                         # WAKE_SOCKET: the echo
    def _():
        me = m & (b == 2)
        rtt_us = (_us31(now) - wake[:, P.AUX].to(torch.int64)) % _US_MOD
        set_reg(st, me, 2, regs(st)[:, 2] + 1)
        col_add(st.stats, ST_RTT_SUM_US, me, rtt_us)
        col_add(st.stats, ST_RTT_COUNT, me)
        col_add(st.stats, ST_XFER_DONE, me)
        # a ping's echo is both its RTT sample and its completion
        netscope.observe(st, me, netscope.NS_RTT, rtt_us)
        netscope.observe(st, me, netscope.NS_COMPLETION, rtt_us)
        limit = cfg_words(hp)[:, 4]
        col_add(st.stats, ST_APP_DONE, me & (limit > 0)
                & (regs(st)[:, 2] >= limit))


def app_ping_server(st, hp, sh, m, now, wake, br, plan):
    reason = wake[:, P.ACK]

    @FL.when(br[0])
    def _():
        ms = m & (reason == WAKE_START)
        slot, _ok = udp_open(st, ms, port=cfg_words(hp)[:, 1])
        set_reg(st, ms, 0, slot.to(torch.int64))

    @FL.when(br[2])
    def _():
        # echo the payload back to the sender, preserving the AUX tag
        md = m & (reason == WAKE_SOCKET)
        udp_sendto(st, hp, md, now, wake[:, P.SEQ], dst_host=wake[:, P.SRC],
                   dst_port=wake[:, P.SPORT], nbytes=wake[:, P.LEN],
                   aux=wake[:, P.AUX])
