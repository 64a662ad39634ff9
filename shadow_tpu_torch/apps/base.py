"""App framework: per-host application state machines on batched rows.

Counterpart of ``shadow_tpu/apps/base.py``. The EV_APP handler calls
:func:`dispatch`, which runs each row's registered app. App calling
convention:

    app(st, hp, sh, m, now, wake, br, plan)

``m`` masks the rows whose wake this app handles, ``wake`` is the
``[H, PKT_WORDS]`` wake packet (ACK = reason, SEQ = socket or -1) and
``br[b]`` is the predicate that some of those rows take branch ``b``
(the reason clipped to [0, 6]: WAKE_START .. WAKE_SENT): an app runs
each branch under ``core.flow.when(br[b])``, so a branch no row takes
is skipped, which saves its launches and changes no row (a bool under
the eager flow, a device scalar in a captured chunk). ``plan`` is the
chunk's ``engine.window.Plan`` (the static loop bounds). Apps keep
their state in ``app_r`` and read ``app_cfg`` through :func:`regs` and
:func:`cfg_words`, the ``[:, 0]`` views: with several processes per
host, :func:`dispatch` hands the apps a single-process copy of each
row's waking process and writes it back after them.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import flow as FL
from ..core import rng as R
from ..core.rowops import rget, rset_where
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
    """[H, 8] int64 register view of the (waking) process slot."""
    return st.app_r[:, 0]


def cfg_words(hp):
    """[H, 8] int64 config words of the (waking) process slot."""
    return hp.app_cfg[:, 0]


def process_of(st, wake):
    """[H] process slot a wake belongs to: the owner of its socket, or
    for a slotless wake the process stamped in its SRC word."""
    slot = wake[:, P.SEQ]
    proc = torch.where(slot >= 0, rget(st.sk_proc, slot), wake[:, P.SRC])
    return proc.clamp(0, st.app_r.shape[1] - 1)


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
    from .tgen import app_tgen
    from ..hosting.bridge import hosted_wake
    return {APP_PING: app_ping, APP_PING_SERVER: app_ping_server,
            APP_PHOLD: app_phold, APP_TGEN: app_tgen, APP_BULK: app_bulk,
            APP_BULK_SERVER: app_bulk_server, APP_GOSSIP: app_gossip,
            APP_SOCKS_CLIENT: app_socks_client,
            APP_SOCKS_PROXY: app_socks_proxy, APP_HOSTED: hosted_wake}


def dispatch(st, hp, sh, m, now, wake, present, proc=None, plan=None):
    """EV_APP entry: run each masked row's app. ``present`` maps each
    app kind of the scenario to its seven branch predicates (some row
    of this pass takes that branch); an app with none runs nothing.

    With one process per host (``proc`` None) the apps run on the
    state itself. Otherwise ``proc`` is each row's waking process
    (:func:`process_of`): the apps run on a copy holding that process's
    registers, config and kind in slot 0 (``app_proc`` = ``proc``, so
    sockets and timers they create belong to it), and the masked rows
    of the registers go back to their process slot. (No app keeps state
    in ``app_node``.)"""
    vst, vhp = st, hp
    if proc is not None:
        rows = torch.arange(proc.shape[0], device=proc.device)
        ix = proc.to(torch.int64)
        vst = dataclasses.replace(st, app_r=st.app_r[rows, ix].unsqueeze(1),
                                  app_proc=proc)
        vhp = dataclasses.replace(
            hp, app_kind=hp.app_kind[rows, ix].unsqueeze(1),
            app_cfg=hp.app_cfg[rows, ix].unsqueeze(1))
    kind = vhp.app_kind[:, 0]
    for k, app in _ported_apps().items():
        br = present.get(k)
        if br is None:
            continue

        @FL.when(FL.any_of(*br))
        def _():
            app(vst, vhp, sh, m & (kind == k), now, wake, br, plan)
    if proc is not None:
        rset_where(st.app_r, proc, m, vst.app_r[:, 0])
