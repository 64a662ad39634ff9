"""Device side of the app-hosting bridge.

Counterpart of ``shadow_tpu/hosting/bridge.py``. Hosted apps run on the
CPU (``hosting/runtime.py``); the whole virtual network stack stays on
the device. Two functions carry the seam:

- :func:`hosted_wake`, the EV_APP handler of APP_HOSTED rows, appends
  each wake to the host's **wake ring** (``Hosts.hw_*``) instead of
  running a device state machine; ``hw_drop`` counts the overflow. The
  drain pops at most one event per row per pass, so the masked append
  at ``hw_cnt`` is exact, and it pauses before any ring can fill
  (``engine/window.py``).
- :func:`apply_ops` replays the apps' syscalls, encoded as fixed op
  words, into device state through the same socket, TCP, UDP, pipe and
  event-queue calls the device apps use.

The reference replays the batch one op at a time. Every op touches only
its own host's row, and each host's ops keep their order, so here the
replay goes by rank within host: pass r applies the r-th op of every
host that has one, with one masked call per opcode present in the pass.
The results stay on the device until the end of the batch: the replay
costs one host sync per flush. The port is wide on the device, so the
reference's widen/narrow around the replay has no counterpart. This is
the plain-PyTorch twin of the op-replay kernel (ROADMAP B4).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.rowops import rget, rset_where, set_where
from ..engine import equeue
from ..engine.defs import EV_APP, WAKE_TIMER
from ..net import packet as P
from ..net.channel import PROTO_PIPE, pipe_close, pipe_open, pipe_write
from ..net.socket import alloc_eport, sock_alloc
from ..net.tcp import (tcp_abort_call, tcp_close_call, tcp_connect,
                       tcp_listen, tcp_write)
from ..net.udp import udp_sendto

# --- op encoding (int64 words) ---
# [host, opcode, a, b, c, d, t, proc]: t is the sim time the app issued
# the op (its wake's time: ops apply at app time, not window time);
# proc is the hosted process's slot on its host, so sockets the replay
# allocates carry the right sk_proc and wake the hosted process even
# when modeled processes share the host
OP_WORDS = 8
OP_NOP = 0
OP_UDP_OPEN = 1      # a=port (0 = ephemeral)           -> slot
OP_TCP_LISTEN = 2    # a=port                           -> slot
OP_TCP_CONNECT = 3   # a=dst host, b=dst port, c=tag    -> slot
OP_TCP_WRITE = 4     # a=slot, b=nbytes
OP_UDP_SENDTO = 5    # a=slot, b=dst host, c=(port<<32)|aux, d=nbytes
OP_CLOSE = 6         # a=slot (tcp/udp or pipe half; proto-dispatched)
OP_TIMER = 7         # a=deadline ns (absolute), b=tag
OP_PIPE_OPEN = 8     # -> packed pair gen_a(7)|slot_a(8)|gen_b(7)|slot_b(8)
OP_ABORT = 9         # a=slot: abortive close (RST when established)

# ops whose word 2 is a socket slot, and so may be a same-batch result
# reference -(k+2) (opens return slots; they never take one)
_SLOT_OPS = (OP_TCP_WRITE, OP_UDP_SENDTO, OP_CLOSE, OP_ABORT)


def hosted_wake(st, hp, sh, m, now, wake, br, plan):
    """EV_APP handler of hosted rows: record the wake for the CPU tier
    (every wake reason takes the same path)."""
    cap = st.hw_time.shape[1]
    ok = m & (st.hw_cnt < cap)
    at = st.hw_cnt.clamp(0, cap - 1)
    rset_where(st.hw_time, at, ok, now)
    rset_where(st.hw_pkt, at, ok, wake)
    st.hw_cnt += ok.to(torch.int32)
    st.hw_drop += (m & ~ok).to(torch.int32)


def _slot_result(st, slot, ok):
    """An open's result: (generation << 16) | slot, or -1, so the host
    side binds the handle to this exact socket incarnation."""
    gen = rget(st.sk_timer_gen, slot).to(torch.int64) & 0x7FFF
    return torch.where(ok, (gen << 16) | slot.to(torch.int64), -1)


def _udp_open(st, m, port):
    """udp_open with a per-row port (0 = pick an ephemeral one); the
    ephemeral cursor advances either way, as in the reference."""
    slot, ok = sock_alloc(st, m, P.PROTO_UDP)
    ep = alloc_eport(st, m)
    rset_where(st.sk_lport, slot, m & ok, torch.where(port > 0, port, ep))
    return slot, ok


def _pipe_result(st, a, b, ok):
    gen_a = rget(st.sk_timer_gen, a).to(torch.int64) & 0x7F
    gen_b = rget(st.sk_timer_gen, b).to(torch.int64) & 0x7F
    packed = ((gen_a << 23) | ((a & 0xFF) << 15) | (gen_b << 8)
              | (b & 0xFF))
    return torch.where(ok, packed, -1)


def _by_proto(st, m, slot, pipe_fn, other_fn):
    """Dispatch a slot verb on the socket's protocol: pipe halves to
    `pipe_fn`, the rest to `other_fn`."""
    is_pipe = rget(st.sk_proto, slot) == PROTO_PIPE
    pipe_fn(m & is_pipe)
    other_fn(m & ~is_pipe)


def _apply_pass(st, hp, sh, rows, ks, words, results):
    """Apply one op on each of `rows` (distinct hosts; op indices `ks`,
    op words `words` [len(rows), 8]) and write their results into
    `results` at `ks`."""
    H = st.hw_cnt.shape[0]
    dev = st.hw_cnt.device
    full = np.zeros((H, OP_WORDS), np.int64)
    full[rows] = words
    has_np = np.zeros(H, bool)
    has_np[rows] = True
    w = torch.from_numpy(full).to(dev)
    has = torch.from_numpy(has_np).to(dev)
    code = w[:, 1]
    sw = code.clamp(0, 9)
    a, b, c, d, now = w[:, 2], w[:, 3], w[:, 4], w[:, 5], w[:, 6]
    PP = st.app_node.shape[1]
    # run in the hosted process's dispatch context: sockets it opens
    # stamp sk_proc = app_proc, so their wakes return to it
    set_where(st.app_proc, has, w[:, 7].clamp(0, PP - 1).to(torch.int32))
    present = {int(x) for x in np.clip(words[:, 1], 0, 9)}
    if present & set(_SLOT_OPS):
        # resolve same-batch references for slot operands only: other
        # words may be legitimate negative scalars (a timer tag)
        j = (-a - 2).clamp(0, results.shape[0] - 1)
        rj = results[j]
        ref = torch.where(rj >= 0, rj & 0xFFFF, -1)
        slot_op = torch.zeros_like(has)
        for op in _SLOT_OPS:
            slot_op |= code == op
        a = torch.where(slot_op & (a < -1), ref, a)
    slot = a.to(torch.int32)
    res = torch.full((H,), -1, dtype=torch.int64, device=dev)
    for op in sorted(present):
        m = has & (sw == op)
        if op == OP_NOP:
            continue
        if op == OP_UDP_OPEN:
            s, ok = _udp_open(st, m, a.to(torch.int32))
            res = torch.where(m, _slot_result(st, s, ok), res)
        elif op == OP_TCP_LISTEN:
            s, ok = tcp_listen(st, m, a.to(torch.int32))
            res = torch.where(m, _slot_result(st, s, ok), res)
        elif op == OP_TCP_CONNECT:
            s, ok = tcp_connect(st, hp, sh, m, now, a.to(torch.int32),
                                b.to(torch.int32), c.to(torch.int32))
            res = torch.where(m, _slot_result(st, s, ok), res)
        elif op == OP_PIPE_OPEN:
            sa, sb, ok = pipe_open(st, m)
            res = torch.where(m, _pipe_result(st, sa, sb, ok), res)
        else:
            if op == OP_TCP_WRITE:
                _by_proto(st, m, slot,
                          lambda mm: pipe_write(st, mm, now, slot, b),
                          lambda mm: tcp_write(st, mm, now, slot, b))
            elif op == OP_UDP_SENDTO:
                udp_sendto(st, hp, m, now, slot, b.to(torch.int32),
                           (c >> 32).to(torch.int32), d,
                           aux=(c & 0xFFFFFFFF).to(torch.int32))
            elif op == OP_CLOSE:
                _by_proto(st, m, slot,
                          lambda mm: pipe_close(st, mm, now, slot),
                          lambda mm: tcp_close_call(st, mm, now, slot))
            elif op == OP_ABORT:
                _by_proto(st, m, slot,
                          lambda mm: pipe_close(st, mm, now, slot),
                          lambda mm: tcp_abort_call(st, mm, now, slot))
            elif op == OP_TIMER:
                # slotless wake: SRC carries the process slot, so the
                # timer returns to the hosted process
                wake = torch.zeros((H, P.PKT_WORDS), dtype=torch.int32,
                                   device=dev)
                wake[:, P.ACK] = WAKE_TIMER
                wake[:, P.SEQ] = -1
                wake[:, P.AUX] = b.to(torch.int32)
                wake[:, P.SRC] = st.app_proc
                equeue.q_push(st, m, a, EV_APP, wake)
            res = torch.where(m, 0, res)
    # restore the between-dispatches invariant (app_proc == 0)
    st.app_proc.masked_fill_(has, 0)
    results[torch.from_numpy(ks).to(dev)] = res[
        torch.from_numpy(rows).to(dev)].to(torch.int32)


def apply_ops(st, hp, sh, ops):
    """Apply a [K, OP_WORDS] int64 numpy op batch in place (each host's
    ops in their order), then clear the wake rings -> results[K]
    int32 numpy (one host sync)."""
    K = ops.shape[0]
    H = st.hw_cnt.shape[0]
    results = torch.full((K,), -1, dtype=torch.int32,
                         device=st.hw_cnt.device)
    host = np.clip(ops[:, 0], 0, H - 1)
    rank = np.zeros(K, np.int64)
    seen = {}
    for k, h in enumerate(host.tolist()):
        rank[k] = seen.get(h, 0)
        seen[h] = rank[k] + 1
    for r in range(int(rank.max()) + 1 if K else 0):
        ks = np.flatnonzero(rank == r)
        _apply_pass(st, hp, sh, host[ks], ks, ops[ks], results)
    st.hw_cnt.zero_()
    return results.cpu().numpy()
