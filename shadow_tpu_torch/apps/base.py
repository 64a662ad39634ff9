"""App framework: per-host application state machines on batched rows.

Counterpart of ``shadow_tpu/apps/base.py``. The EV_APP handler calls
:func:`dispatch`, which runs each row's registered app. App calling
convention:

    app(st, hp, sh, m, now, wake, branches)

``m`` masks the rows whose wake this app handles, ``wake`` is the
``[H, PKT_WORDS]`` wake packet (ACK = reason, SEQ = socket or -1) and
``branches`` is the set of branch indices (the reason clipped to
[0, 6]: WAKE_START .. WAKE_SENT) that at least one of those rows takes: a branch no row takes
is skipped, which saves its launches and changes no row. Apps keep
their state in ``app_node``/``app_r`` and read ``app_cfg``; with one
process slot per host those are the ``[:, 0]`` views.
"""

from __future__ import annotations

import torch

from ..core import rng as R
from ..engine import equeue
from ..engine.defs import EV_APP, WAKE_TIMER
from ..net import packet as P

# App kind registry (the reference's lax.switch order).
APP_NULL = 0
APP_PING = 1
APP_PING_SERVER = 2
APP_PHOLD = 3
APP_TGEN = 4
APP_BULK = 5
APP_BULK_SERVER = 6
APP_HOSTED = 7
APP_GOSSIP = 8
APP_SOCKS_CLIENT = 9
APP_SOCKS_PROXY = 10
N_APP_KINDS = 11
N_BRANCHES = 7      # wake reasons WAKE_START=0 .. WAKE_SENT=6


def regs(st):
    """[H, 8] int64 register view of the single process slot."""
    return st.app_r[:, 0]


def cfg_words(hp):
    """[H, 8] int64 config words of the single process slot."""
    return hp.app_cfg[:, 0]


def branch_of(wake):
    """[H] branch index of a wake: its reason clipped to [0, 6]."""
    return wake[:, P.ACK].clamp(0, N_BRANCHES - 1)


def set_reg(st, m, i: int, val):
    """app_r[:, 0, i] = val where m."""
    r = regs(st)
    r[:, i] = torch.where(m, val, r[:, i])


def draw(st, hp, m):
    """One uniform float32 in [0, 1) per row from the counter PRNG;
    masked rows advance their rng_ctr."""
    u = R.cheap_uniform(hp.rng_stream, st.rng_ctr)
    st.rng_ctr += m.to(torch.int32)
    return u


def schedule_wake(st, m, t, reason, sock=-1, aux=0, wnd=0, ln=0):
    """Push a future EV_APP for each masked row: reason in ACK, `sock`
    in SEQ (-1: slotless), `aux`/`wnd`/`ln` in AUX/WND/LEN; the SRC
    word carries the scheduling process slot (app_proc)."""
    wake = torch.zeros((st.eq_ctr.shape[0], P.PKT_WORDS), dtype=torch.int32,
                       device=st.eq_ctr.device)
    wake[:, P.ACK] = reason
    wake[:, P.SEQ] = sock
    wake[:, P.AUX] = aux
    wake[:, P.WND] = wnd
    wake[:, P.LEN] = ln
    wake[:, P.SRC] = st.app_proc
    equeue.q_push(st, m, t, EV_APP, wake)


def timer(st, m, t, aux=0):
    schedule_wake(st, m, t, WAKE_TIMER, aux=aux)


def _ported_apps():
    from .bulk import app_bulk, app_bulk_server
    from .gossip import app_gossip
    from .phold import app_phold
    from .ping import app_ping, app_ping_server
    from .socks import app_socks_client, app_socks_proxy
    return {APP_PING: app_ping, APP_PING_SERVER: app_ping_server,
            APP_PHOLD: app_phold, APP_BULK: app_bulk,
            APP_BULK_SERVER: app_bulk_server, APP_GOSSIP: app_gossip,
            APP_SOCKS_CLIENT: app_socks_client,
            APP_SOCKS_PROXY: app_socks_proxy}


def dispatch(st, hp, sh, m, now, wake, present):
    """EV_APP entry: run each masked row's app. ``present`` is the set
    of (app kind, branch) pairs some row takes in this pass."""
    kind = hp.app_kind[:, 0]
    for k, app in _ported_apps().items():
        branches = {b for kk, b in present if kk == k}
        if branches:
            app(st, hp, sh, m & (kind == k), now, wake, branches)
