"""PHOLD: the classic parallel-DES stress benchmark.

Counterpart of ``shadow_tpu/apps/phold.py``: every host holds messages;
on receiving one it schedules a send to a uniformly random peer after
an exponential delay.

Config (app_cfg): c0=num hosts, c1=port, c2=mean delay ns,
c3=payload bytes, c4=initial messages per host.
Registers: r0=socket, r1=messages sent.
"""

from __future__ import annotations

import torch

from ..core import flow as FL
from ..core.rng import log1p_f32
from ..net.udp import udp_open, udp_sendto
from .base import branch_of, cfg_words, draw, regs, set_reg, timer


def exp_delay_ns(u, mean_ns):
    """[H] int64 exponential delay from uniforms `u` (float32) and the
    int64 mean: float32 throughout, truncated, at least 1 ns."""
    d = (-mean_ns.to(torch.float32) * log1p_f32(-u)).to(torch.int64)
    return d.clamp(min=1)


def _exp_delay(st, hp, m):
    """[H] exponential delay with mean c2 (ns), minimum 1 ns."""
    return exp_delay_ns(draw(st, hp, m), cfg_words(hp)[:, 2])


def _send_to_random_peer(st, hp, m, now):
    u = draw(st, hp, m)
    c = cfg_words(hp)
    n = c[:, 0]
    peer = torch.minimum((u * n).to(torch.int64), n - 1)
    # avoid self: shift by one
    peer = torch.where(peer == hp.hid, (peer + 1) % n, peer)
    udp_sendto(st, hp, m, now, regs(st)[:, 0], dst_host=peer,
               dst_port=c[:, 1], nbytes=c[:, 3])
    set_reg(st, m, 1, regs(st)[:, 1] + 1)


def app_phold(st, hp, sh, m, now, wake, br, plan):
    b = branch_of(wake)

    @FL.when(br[0])                         # WAKE_START
    def _():
        ms = m & (b == 0)
        slot, _ok = udp_open(st, ms, port=cfg_words(hp)[:, 1])
        set_reg(st, ms, 0, slot.to(torch.int64))
        # seed c4 initial messages at exponential offsets; the
        # reference's per-row fori_loop bound becomes a loop to the
        # scenario's largest bound (the plan's, clamped to the queue)
        # with a per-row mask: a row past its own bound draws nothing
        qcap = st.eq_time.shape[1]
        n0 = cfg_words(hp)[:, 4].clamp(0, qcap)
        for i in range(plan.phold_seed):
            mi = ms & (i < n0)
            timer(st, mi, now + _exp_delay(st, hp, mi))

    @FL.when(br[1])                         # WAKE_TIMER: send
    def _():
        _send_to_random_peer(st, hp, m & (b == 1), now)

    @FL.when(br[2])                         # WAKE_SOCKET: a message
    def _():
        mm = m & (b == 2)
        timer(st, mm, now + _exp_delay(st, hp, mm))
