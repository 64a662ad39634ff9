"""numpy restatements of the chunk kernels' functions
(``shadow_tpu_torch/core/kernels.py``: pass_flags, advance,
advance_lanes) and the inputs the tests hold them on.

The restatements are the bookkeeping the kernels replace, as the eager
loop computed it on the host. Shared by the CPU tests
(``test_torch_kernels.py``) and the card's (``test_torch_cuda.py``);
imports neither jax nor the JAX package.
"""

import numpy as np

from shadow_tpu_torch.core import kernels as K
from shadow_tpu_torch.core.simtime import SIMTIME_MAX
from shadow_tpu_torch.engine.defs import EV_NULL
from shadow_tpu_torch.engine.window import _N_CODES

# the row counts the kernels are held at (chip_smoke.py's CHECK_ROWS):
# one row, a ragged 16-byte tail, a block's width and one past it, the
# main path's counts (phold-4096, socks10k, gossip-100k) and one past
EDGE_ROWS = (1, 3, 1023, 1025, 4096, 4097, 10_000, 16_384, 100_000,
             100_003)
N_BITS = 11                             # feature bits, as the TCP drain
CONT, STOP = 1 << 10, 1 << 3            # a go-on bit and a stop bit


def pass_flags_np(code, feat, n_codes, n_bits, null, cont_mask, stop_mask):
    """Codes outside [0, n_codes) mark nothing, as in the kernel."""
    present = np.zeros(n_codes, np.int32)
    present[np.unique(code[(code >= 0) & (code < n_codes)])] = 1
    word = int(np.bitwise_or.reduce(feat)) if feat is not None and len(
        feat) else 0
    bits = [(word >> j) & 1 for j in range(n_bits)]
    live = bool((code != null).any()) or bool(word & cont_mask)
    return list(present) + bits + [int(live and not word & stop_mask)]


def advance_np(eq_next, ob_next, ob_cnt, W, mode):
    """The run loop's window boundary as the eager loop computed it on
    the host (next_event_time, ob_cnt.sum(), next_wakeup)."""
    W = list(W)
    mq = int(eq_next.min())
    if mode == K.ADV_SHIP:
        W[K.W_OB0] = int(ob_cnt.sum())
        W[K.W_EX] = int(W[K.W_OB0] > 0)
        return W
    if mode == K.ADV_STEP:
        progressed = W[K.W_RAN] or int(ob_cnt.sum()) < W[K.W_OB0]
        nt = min(mq, int(ob_next.min())) if progressed else mq
        W[K.W_WS] = nt
        W[K.W_WE] = SIMTIME_MAX if nt == SIMTIME_MAX else nt + W[K.W_JUMP]
        W[K.W_I] += 1
    ws = W[K.W_WS]
    W[K.W_CONT] = int(W[K.W_I] < W[K.W_MAXW] and ws < W[K.W_STOP]
                      and ws < SIMTIME_MAX)
    W[K.W_WEFF] = min(W[K.W_WE], W[K.W_STOP])
    W[K.W_RAN] = int(mq < W[K.W_WEFF])
    return W


def advance_lanes_np(eq_next, ob_next, ob_cnt, Ws, mode):
    """Each lane's boundary as the eager batch loop computed it: lane b
    (rows [b*H, (b+1)*H)) takes ``advance_np`` unless it is frozen (its
    W_CONT is 0, ADV_SHIP and ADV_STEP only) -> (the lanes' W lists,
    the batch's flag: some lane goes on (ADV_OPEN, ADV_STEP) or some
    live lane ships (ADV_SHIP))."""
    B = len(Ws)
    H = len(eq_next) // B
    out = []
    for b, W in enumerate(Ws):
        rows = slice(b * H, (b + 1) * H)
        live = mode == K.ADV_OPEN or W[K.W_CONT]
        out.append(advance_np(eq_next[rows], ob_next[rows], ob_cnt[rows],
                              W, mode) if live else list(W))
    if mode == K.ADV_SHIP:
        flag = any(W[K.W_CONT] and W[K.W_EX] for W in out)
    else:
        flag = any(W[K.W_CONT] for W in out)
    return out, int(flag)


def lane_scalars_np(B, H, seed):
    """B lanes' window scalars from a seed (``window_scalars_np``), about
    a third of them frozen (W_CONT 0) and the others live."""
    rng = np.random.RandomState(seed)
    Ws = [window_scalars_np(seed * 31 + b, H) for b in range(B)]
    for W in Ws:
        W[K.W_CONT] = int(rng.rand() < 0.67)
        W[K.W_EX] = int(rng.randint(0, 2))
    return Ws


def flag_rows(H, rows, seed):
    """A drain pass's codes and feature words at H rows: "random" (half
    the rows idle), "idle" (every row EV_NULL), "ends" (codes 0 and
    _N_CODES - 1 only, 0 on the first row and _N_CODES - 1 on the last)
    or "outside" (random, with codes -1 and _N_CODES among them, which
    only the kernel takes)."""
    rng = np.random.RandomState(seed)
    code = np.where(rng.rand(H) < 0.5, EV_NULL, rng.randint(0, _N_CODES, H))
    if rows == "idle":
        code[:] = EV_NULL
    elif rows == "ends":
        code = rng.choice([0, _N_CODES - 1], H)
        code[-1], code[0] = _N_CODES - 1, 0
    elif rows == "outside":
        code[rng.rand(H) < 0.1] = -1
        code[rng.rand(H) < 0.1] = _N_CODES
    feat = ((rng.rand(H, N_BITS) < min(0.5, 4.0 / H))
            << np.arange(N_BITS)).sum(1)
    feat &= ~STOP
    return code.astype(np.int32), feat.astype(np.int32)


def flag_cases(code, feat):
    """pass_flags' argument sets on one pass's rows: the feature words
    with no stop bit, the same with a stop bit on one row, and no
    feature words."""
    stopped = feat.copy()
    stopped[len(feat) // 2] |= STOP
    return [(code, feat, _N_CODES, N_BITS, EV_NULL, CONT, STOP),
            (code, stopped, _N_CODES, N_BITS, EV_NULL, CONT, STOP),
            (code, None, _N_CODES, 0, EV_NULL, 0, 0)]


def window_rows(H, queues, seed):
    """A window boundary's rows at H: the queues' next events, the
    outboxes' next arrivals and counts; "random" (some queues empty),
    "empty" (every queue and outbox at SIMTIME_MAX, no packets) or
    "outboxes" (every queue empty, outboxes random)."""
    rng = np.random.RandomState(seed)
    eq = rng.randint(0, 5 * 10**9, H).astype(np.int64)
    ob = rng.randint(0, 5 * 10**9, H).astype(np.int64)
    eq[rng.rand(H) < 0.3] = SIMTIME_MAX
    ob[rng.rand(H) < 0.7] = SIMTIME_MAX
    cnt = rng.randint(0, 3, H).astype(np.int32)
    if queues == "empty":
        eq[:], ob[:], cnt[:] = SIMTIME_MAX, SIMTIME_MAX, 0
    elif queues == "outboxes":
        eq[:] = SIMTIME_MAX
    return eq, ob, cnt


def window_scalars_np(seed, H):
    """Window scalars (a list, [K.W_LEN]) from a seed: a window start
    below or above the stop time, the window counter at or below its
    limit, the ran flag either way, a shipped count around H."""
    rng = np.random.RandomState(seed)
    W = [0] * K.W_LEN
    W[K.W_WS] = int(rng.randint(0, 4 * 10**9))
    W[K.W_WE] = W[K.W_WS] + 10**7
    W[K.W_STOP] = int(rng.choice([3 * 10**9, 6 * 10**9]))
    W[K.W_JUMP], W[K.W_MAXW] = 10**7, int(rng.randint(1, 4))
    W[K.W_I] = int(rng.randint(0, 4))
    W[K.W_RAN], W[K.W_OB0] = int(rng.randint(0, 2)), int(
        rng.randint(0, 2 * H + 1))
    return W
