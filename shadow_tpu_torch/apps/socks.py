"""SOCKS-style proxy chains: client -> relay(s) -> server fetches.

Counterpart of ``shadow_tpu/apps/socks.py``. A client picks a random
relay and target server and connects to the relay with a SYN tag that
encodes (hops, target, size) — the SOCKS CONNECT header; the relay
opens the onward leg (to another random relay while hops remain, else
to the target with a plain GET tag) and streams response bytes back;
the client's EOF completes the fetch (its delay goes into the RTT
stats). Relay pairing lives in sk_app_ref.

Tag bits: 29-30 relay hops remaining, 9-28 target host id, 0-8 size
in 4 KiB units.

Client config: c0=relay_lo, c1=relay_hi, c2=relay port, c3=server_lo,
c4=server_hi, c5=size (4 KiB units), c6=count (0 = forever),
c7=pause ns | (hops << 56).
Client registers: r0=socket, r1=fetches done, r2=fetch start time.
Proxy config: c1=listen port, c2=server port, c3=relay_lo, c4=relay_hi.
Proxy registers: r0 = 1 + listener slot (0 = listen failed).
"""

from __future__ import annotations

import torch

from ..core.rowops import col_add, rget, rset_where
from ..engine.defs import (ST_APP_DONE, ST_CHAIN_SHORT, ST_RTT_COUNT,
                           ST_RTT_SUM_US, ST_XFER_DONE)
from ..net import packet as P
from ..net.tcp import tcp_close_call, tcp_connect, tcp_listen, tcp_write
from ..obs import netscope
from .base import branch_of, cfg_words, draw, regs, set_reg, timer

TAG_HOPS_SHIFT = 29
TAG_HOST_SHIFT = 9
TAG_HOST_MASK = 0xFFFFF
TAG_U4K_MASK = 0x1FF

_I32 = torch.int32
_I64 = torch.int64


def pack_tag(target_host, size_u4k, hops=0):
    hops = torch.as_tensor(hops, device=target_host.device).to(_I32)
    return (((hops & 0x3) << TAG_HOPS_SHIFT) |
            ((target_host.to(_I32) & TAG_HOST_MASK) << TAG_HOST_SHIFT) |
            (size_u4k.to(_I32) & TAG_U4K_MASK))


def _rand_in(st, hp, m, lo, hi, skip_self=False):
    """Uniform host id in [lo, hi) per row (one draw on masked rows);
    with skip_self this host is excluded when it lies in the range."""
    u = draw(st, hp, m)
    n = (hi - lo).clamp(min=1)
    if skip_self:
        in_pool = (hp.hid >= lo) & (hp.hid < hi) & (n > 1)
        n_eff = n - in_pool.to(_I64)
        idx = torch.minimum((u * n_eff.to(torch.float32)).to(_I64),
                            n_eff - 1)
        idx = torch.where(in_pool & (lo + idx >= hp.hid), idx + 1, idx)
        return (lo + idx).to(_I32)
    return (lo + torch.minimum((u * n.to(torch.float32)).to(_I64),
                               n - 1)).to(_I32)


def app_socks_client(st, hp, sh, m, now, wake, branches):
    b = branch_of(wake)
    c = cfg_words(hp)
    slot = wake[:, P.SEQ]
    fresh = wake[:, P.WND] == rget(st.sk_timer_gen, slot)
    pause = c[:, 7] & ((1 << 56) - 1)
    hops = (c[:, 7] >> 56).to(_I32)

    if 0 in branches or 1 in branches:      # START, TIMER: a fetch
        mf = m & ((b == 0) | (b == 1))
        proxy = _rand_in(st, hp, mf, c[:, 0], c[:, 1])
        server = _rand_in(st, hp, mf, c[:, 3], c[:, 4])
        # hops=1 is one relay: the tag counts extensions beyond it
        tag = pack_tag(server, c[:, 5], (hops - 1).clamp(min=0))
        s, ok = tcp_connect(st, hp, sh, mf, now, dst_host=proxy,
                            dst_port=c[:, 2].to(_I32), tag=tag)
        set_reg(st, mf, 0, s.to(_I64))
        set_reg(st, mf, 2, now)
        # connect failure: retry after the pause
        timer(st, mf & ~ok, now + pause)

    if 4 in branches:                       # EOF: the response is in
        me = m & (b == 4) & fresh & (slot == regs(st)[:, 0].to(_I32))
        # a refused relay closes with zero bytes delivered: retry, and
        # never count it as a fetch
        got = rget(st.sk_rcv_nxt, slot) > 0
        md = me & got
        delay_us = torch.div((now - regs(st)[:, 2]).clamp(min=0), 1000,
                             rounding_mode="floor")
        tcp_close_call(st, me, now, slot)
        set_reg(st, md, 1, regs(st)[:, 1] + 1)
        col_add(st.stats, ST_XFER_DONE, md)
        col_add(st.stats, ST_RTT_SUM_US, md, delay_us)
        col_add(st.stats, ST_RTT_COUNT, md)
        # the fetch delay is both the RTT sample and the completion
        netscope.observe(st, md, netscope.NS_RTT, delay_us)
        netscope.observe(st, md, netscope.NS_COMPLETION, delay_us)
        fin = md & (c[:, 6] > 0) & (regs(st)[:, 1] >= c[:, 6])
        col_add(st.stats, ST_APP_DONE, fin)
        timer(st, me & ~fin, now + pause)


def app_socks_proxy(st, hp, sh, m, now, wake, branches):
    b = branch_of(wake)
    c = cfg_words(hp)
    slot = wake[:, P.SEQ]
    fresh = wake[:, P.WND] == rget(st.sk_timer_gen, slot)
    paired = rget(st.sk_app_ref, slot)
    is_child = rget(st.sk_parent, slot) >= 0     # client-facing side

    if 0 in branches:                       # START: listen
        ms = m & (b == 0)
        lslot, ok = tcp_listen(st, ms, c[:, 1].to(_I32))
        set_reg(st, ms, 0, torch.where(ok, lslot.to(_I64) + 1, 0))

    if 5 in branches:                       # ACCEPT: SOCKS CONNECT
        ma = m & (b == 5)
        tag = rget(st.sk_syn_tag, slot)
        hops = (tag >> TAG_HOPS_SHIFT) & 0x3
        target = ((tag >> TAG_HOST_SHIFT) & TAG_HOST_MASK).to(_I32)
        size = (tag & TAG_U4K_MASK) << 12
        # an extension pool must offer a relay other than this one
        n_pool = c[:, 4] - c[:, 3]
        self_in = (hp.hid >= c[:, 3]) & (hp.hid < c[:, 4])
        has_pool = (n_pool > 1) | ((n_pool == 1) & ~self_in)
        extend = (hops > 0) & has_pool
        col_add(st.stats, ST_CHAIN_SHORT, ma & (hops > 0) & ~has_pool & fresh)
        mg = ma & fresh
        nxt = _rand_in(st, hp, mg, c[:, 3], c[:, 4], skip_self=True)
        dst = torch.where(extend, nxt, target)
        # chain extension dials the next relay on this relay's own port
        dport = torch.where(extend, c[:, 1], c[:, 2]).to(_I32)
        otag = torch.where(extend,
                           pack_tag(target, tag & TAG_U4K_MASK, hops - 1),
                           size)
        onward, ok = tcp_connect(st, hp, sh, mg, now, dst_host=dst,
                                 dst_port=dport, tag=otag)
        mp = mg & ok
        rset_where(st.sk_app_ref, onward, mp, slot)
        rset_where(st.sk_app_ref, slot, mp, onward)
        # onward table full: refuse the client
        tcp_close_call(st, mg & ~ok, now, slot)

    if 2 in branches:                       # SOCKET: relay response bytes
        ln = wake[:, P.LEN].to(_I64)
        mr = m & (b == 2) & fresh & ~is_child & (paired >= 0) & (ln > 0)
        tcp_write(st, mr, now, paired, ln)

    if 4 in branches:                       # EOF: close the pair
        me = m & (b == 4) & fresh
        rset_where(st.sk_app_ref, slot, me, -1)
        rset_where(st.sk_app_ref, paired, me, -1)
        tcp_close_call(st, me, now, slot)
        tcp_close_call(st, me & (paired >= 0), now, paired)
