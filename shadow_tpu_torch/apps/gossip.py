"""Block-gossip app: Bitcoin-style tip propagation over a random overlay.

Counterpart of ``shadow_tpu/apps/gossip.py``. Miners produce blocks of
increasing height at a fixed interval; every node relays a block the
FIRST time it sees it to ``fanout`` uniformly random peers. Height h
was mined at ``mine_start + h * interval``, so each first sight adds
``now - mined_at`` to the latency accumulators (ST_RTT_SUM_US /
ST_RTT_COUNT: summary()'s mean_rtt_us is the mean propagation delay).

app_cfg: [0]=num_hosts, [1]=port, [2]=fanout, [3]=interval ns,
         [4]=miner (0/1), [5]=payload bytes
app_r:   r0=socket, r1=highest height seen, r2=first-sight receptions,
         r4=blocks mined, r5=start epoch

Peer draws always consume MAX_FANOUT PRNG values, so the per-host draw
sequence does not depend on the configured fanout.
"""

from __future__ import annotations

import torch

from ..core.rowops import col_add
from ..engine.defs import ST_RTT_COUNT, ST_RTT_SUM_US, ST_XFER_DONE
from ..net import packet as P
from ..net.udp import udp_open, udp_sendto
from ..obs import netscope
from .base import branch_of, cfg_words, draw, regs, set_reg, timer

MAX_FANOUT = 8


def _relay(st, hp, m, now, height):
    """Send `height` to fanout random peers (always MAX_FANOUT draws)."""
    c = cfg_words(hp)
    n = c[:, 0].clamp(min=2)
    k = c[:, 2].clamp(0, MAX_FANOUT)
    port = c[:, 1].to(torch.int32)
    sock = regs(st)[:, 0].to(torch.int32)
    aux = height.to(torch.int32)
    nf = (n - 1).to(torch.float32)
    for j in range(MAX_FANOUT):
        u = draw(st, hp, m)
        peer = torch.minimum((u * nf).to(torch.int64), n - 2)
        # skip self: indices >= hid shift up by one
        peer = torch.where(peer >= hp.hid, peer + 1, peer).to(torch.int32)
        udp_sendto(st, hp, m & (j < k), now, sock, peer, port, c[:, 5],
                   aux=aux)


def app_gossip(st, hp, sh, m, now, wake, branches):
    b = branch_of(wake)
    c = cfg_words(hp)
    interval = c[:, 3]
    if 0 in branches:                       # WAKE_START
        ms = m & (b == 0)
        slot, _ok = udp_open(st, ms, port=c[:, 1].to(torch.int32))
        set_reg(st, ms, 0, slot.to(torch.int64))
        # r5 = the common start epoch: height h is mined at r5 + h*interval
        set_reg(st, ms, 5, now)
        timer(st, ms & (c[:, 4] != 0), now + interval)
    if 1 in branches:                       # WAKE_TIMER: mine and gossip
        mt = m & (b == 1)
        h = regs(st)[:, 4] + 1
        set_reg(st, mt, 4, h)
        set_reg(st, mt, 1, torch.maximum(regs(st)[:, 1], h))
        _relay(st, hp, mt, now, h)
        timer(st, mt, now + interval)
    if 2 in branches:                       # WAKE_SOCKET: a block
        h = wake[:, P.AUX].to(torch.int64)
        mf = m & (b == 2) & (h > regs(st)[:, 1])
        mined_at = regs(st)[:, 5] + h * interval
        delay_us = (now - mined_at).clamp(min=0) // 1000
        set_reg(st, mf, 2, regs(st)[:, 2] + 1)
        set_reg(st, mf, 1, h)
        col_add(st.stats, ST_XFER_DONE, mf)
        col_add(st.stats, ST_RTT_SUM_US, mf, delay_us)
        col_add(st.stats, ST_RTT_COUNT, mf)
        netscope.observe(st, mf, netscope.NS_RTT, delay_us)
        _relay(st, hp, mf, now, h)
