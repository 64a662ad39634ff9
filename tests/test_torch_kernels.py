"""The chunk kernels' plain versions (``shadow_tpu_torch/core/kernels.py``:
``pass_flags_plain``, ``advance_plain``, ``advance_lanes_plain``) against
the numpy restatements of the bookkeeping they replace
(``torch_kernels_np.py``), at the row counts the kernels are held at on
the card; and the wrappers' launches on their tensors' card.

The cases are the kernels' edges: idle rows, codes at 0 and at
``n_codes - 1``, codes outside the range (which the plain version
refuses and the kernel ignores), a stop bit on one row, and queues and
outboxes all at SIMTIME_MAX; then the drain's own mixes of idle rows
and feature bits, and random window scalars. No reference run: the
kernels themselves run only on the card (``test_torch_cuda.py``), and
on the CPU each wrapper runs its plain version.
"""

import numpy as np
import pytest
import torch

from shadow_tpu_torch.core import kernels as K
from shadow_tpu_torch.core.simtime import SIMTIME_MAX
from shadow_tpu_torch.engine import window as WN
from shadow_tpu_torch.engine.defs import EV_NULL, N_EVENT_KINDS
from shadow_tpu_torch.engine.window import _N_CODES

from torch_kernels_np import (EDGE_ROWS, advance_lanes_np, advance_np,
                              flag_cases, flag_rows, lane_scalars_np,
                              pass_flags_np, window_rows, window_scalars_np)
from torch_threads import one_torch_thread_everywhere  # noqa: F401


def _tensor(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("rows", ["random", "idle", "ends"])
@pytest.mark.parametrize("H", EDGE_ROWS)
def test_pass_flags_plain_matches_the_bitmap(H, rows):
    """Codes present, feature bits and the go-on flag; a stop bit on
    one row stops the pass loop, and all-idle rows stop it with no
    go-on bit."""
    code, feat = flag_rows(H, rows, seed=H)
    for i, (c, f, *rest) in enumerate(flag_cases(code, feat)):
        got = K.pass_flags(_tensor(c), _tensor(f), *rest)
        want = pass_flags_np(c, f, *rest)
        assert got.dtype == torch.int32
        assert got.tolist() == want
        if i == 1:
            assert want[-1] == 0                # the stop bit
        if rows == "idle" and f is None:
            assert want[-1] == 0 and want[EV_NULL] == 1
        if rows == "ends":
            assert want[0] == 1 and want[_N_CODES - 1] == int(H > 1)
    assert K.LAUNCHES == {"pass_flags": 0, "advance": 0,
                          "advance_lanes": 0}


@pytest.mark.parametrize("H", (1, 1025, 100_003))
def test_pass_flags_plain_refuses_codes_outside_the_range(H):
    """The plain version takes codes in [0, n_codes) only; the kernel
    ignores the others, which the restatement shows."""
    code, feat = flag_rows(H, "outside", seed=H)
    code[0] = -1
    c, f, *rest = flag_cases(code, feat)[0]
    with pytest.raises(RuntimeError):
        K.pass_flags(_tensor(c), _tensor(f), *rest)
    inside = (c >= 0) & (c < _N_CODES)
    want = pass_flags_np(c, f, *rest)
    assert want[:_N_CODES] == pass_flags_np(
        c[inside], f[inside], *rest)[:_N_CODES]


@pytest.mark.parametrize("queues", ["random", "empty", "outboxes"])
@pytest.mark.parametrize("H", EDGE_ROWS)
def test_advance_plain_matches_the_eager_advance(H, queues):
    """Every advance mode on window scalars from several seeds, queues
    and outboxes all at SIMTIME_MAX included."""
    eq, ob, cnt = window_rows(H, queues, seed=H)
    for seed in range(4):
        W = window_scalars_np(seed, H)
        for mode in (K.ADV_OPEN, K.ADV_SHIP, K.ADV_STEP):
            got = K.advance(_tensor(eq), _tensor(ob), _tensor(cnt),
                            torch.tensor(W, dtype=torch.int64), mode)
            assert got.tolist() == advance_np(eq, ob, cnt, W, mode), (
                seed, mode)
    if queues == "empty":
        W = window_scalars_np(0, H)
        got = advance_np(eq, ob, cnt, W, K.ADV_STEP)
        assert got[K.W_WS] == got[K.W_WE] == np.iinfo(np.int64).max
        assert got[K.W_CONT] == 0
    assert K.LAUNCHES == {"pass_flags": 0, "advance": 0,
                          "advance_lanes": 0}


@pytest.mark.parametrize("H,p_null,p_bit", ((1, 0.5, 0.3), (64, 0.9, 0.05),
                                            (1000, 1.0, 0.001),
                                            (300, 0.2, 0.0)))
def test_pass_flags_plain_matches_the_drain_mix(H, p_null, p_bit):
    """The pass's dispatch bitmap, feature bits and go-on flag, as the
    drain read them from its flags (``set`` of codes present, each part
    any-of, nothing-ready or a hosted pause stops), on random rows with
    the drain's shares of idle rows and feature bits."""
    rng = np.random.RandomState(H)
    n_codes = N_EVENT_KINDS + 7 * 11
    code = np.where(rng.rand(H) < p_null, EV_NULL,
                    rng.randint(0, n_codes, H)).astype(np.int32)
    feat = ((rng.rand(H, 12) < p_bit) << np.arange(12)).sum(1).astype(
        np.int32)
    for f, nb, cm, sm in ((feat, 12, 1 << 10, 1 << 11), (None, 0, 0, 0)):
        got = K.pass_flags(torch.from_numpy(code), _tensor(f), n_codes, nb,
                           EV_NULL, cm, sm)
        assert got.dtype == torch.int32
        assert got.tolist() == pass_flags_np(code, f, n_codes, nb, EV_NULL,
                                             cm, sm)
    assert K.LAUNCHES == {"pass_flags": 0, "advance": 0,
                          "advance_lanes": 0}


@pytest.mark.parametrize("H", (1, 7, 500))
def test_advance_plain_matches_random_window_scalars(H):
    """Each advance mode equals the eager loop's host arithmetic on
    random queues and outboxes and random window scalars, empty queues
    and the stop time included."""
    rng = np.random.RandomState(11 + H)
    for trial in range(12):
        eq = rng.randint(0, 5 * 10**9, H).astype(np.int64)
        ob = rng.randint(0, 5 * 10**9, H).astype(np.int64)
        eq[rng.rand(H) < (0.5 if trial % 3 else 1.0)] = SIMTIME_MAX
        ob[rng.rand(H) < (0.5 if trial % 2 else 1.0)] = SIMTIME_MAX
        cnt = rng.randint(0, 3, H).astype(np.int32)
        W = [int(v) for v in WN.window_scalars(
            int(rng.randint(0, 4 * 10**9)), 0,
            int(rng.choice([3 * 10**9, 6 * 10**9])), 10**7,
            int(rng.randint(1, 4))).tolist()]
        W[K.W_WE] = W[K.W_WS] + 10**7
        W[K.W_I] = int(rng.randint(0, 3))
        W[K.W_RAN], W[K.W_OB0] = int(rng.randint(0, 2)), int(
            rng.randint(0, 2 * H))
        for mode in (K.ADV_OPEN, K.ADV_SHIP, K.ADV_STEP):
            got = K.advance(torch.from_numpy(eq), torch.from_numpy(ob),
                            torch.from_numpy(cnt),
                            torch.tensor(W, dtype=torch.int64), mode)
            assert got.tolist() == advance_np(eq, ob, cnt, W, mode), (
                trial, mode)


@pytest.mark.parametrize("queues", ["random", "empty", "outboxes"])
@pytest.mark.parametrize("B", (1, 2, 4, 7))
def test_advance_lanes_plain_matches_each_lane_alone(B, queues):
    """Every mode on B stacked lanes (1 to 4,097 rows a lane), about a
    third of them frozen: each live lane's row equals ``advance_np`` on
    its own rows, a frozen lane's row is unchanged, and the batch's row
    holds the OR of the go-on flags or of the live lanes' ship flags;
    one lane equals ``advance_plain``."""
    for H in (1, 3, 1025, 4097):
        eq, ob, cnt = window_rows(B * H, queues, seed=B * H)
        for seed in range(3):
            Ws = lane_scalars_np(B, H, seed)
            for mode in (K.ADV_OPEN, K.ADV_SHIP, K.ADV_STEP):
                W = torch.tensor(Ws, dtype=torch.int64)
                G = torch.zeros(K.W_LEN + 1, dtype=torch.int64)
                K.advance_lanes(_tensor(eq), _tensor(ob), _tensor(cnt), W,
                                G, mode)
                want, flag = advance_lanes_np(eq, ob, cnt, Ws, mode)
                assert W.tolist() == want, (H, seed, mode)
                i = K.W_EX if mode == K.ADV_SHIP else K.W_CONT
                assert G.tolist() == [flag if j == i else 0
                                      for j in range(K.W_LEN + 1)]
                if B == 1 and Ws[0][K.W_CONT]:
                    one = K.advance(_tensor(eq), _tensor(ob), _tensor(cnt),
                                    torch.tensor(Ws[0]), mode)
                    assert W[0].tolist() == one.tolist()
    assert K.LAUNCHES == {"pass_flags": 0, "advance": 0,
                          "advance_lanes": 0}


class _OnCard:
    """What a wrapper reads of a tensor, on a named card."""

    def __init__(self, t, device):
        self.t, self.device = t, torch.device(device)
        self.dtype, self.shape = t.dtype, t.shape

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0

    def dim(self):
        return self.t.dim()

    def numel(self):
        return self.t.numel()


def test_wrappers_launch_on_their_tensors_card(monkeypatch):
    """Each kernel wrapper asks for the current stream of its tensors'
    card (cuda:1 here, cuda:0 being current) and launches inside
    ``torch.cuda.device`` of that card, so a kernel never runs on
    another card's stream or context."""
    import contextlib
    import types
    current, log = ["cuda:0"], []

    @contextlib.contextmanager
    def device(d):
        outer, current[0] = current[0], str(torch.device(d))
        try:
            yield
        finally:
            current[0] = outer

    def stream(device=None):
        log.append(("stream", str(device)))
        return types.SimpleNamespace(cuda_stream=11)

    class Lib:
        def __getattr__(self, name):
            def launch(s, *args):
                log.append((name, current[0], s))
                return 0
            return launch

    empty = torch.empty
    monkeypatch.setattr(K, "lib", Lib)
    monkeypatch.setattr(K, "LAUNCHES", dict.fromkeys(K.LAUNCHES, 0))
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", stream)
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw:
                        empty(*a, **kw))
    eq, ob, cnt = (_OnCard(torch.from_numpy(a), "cuda:1")
                   for a in window_rows(8, "random", seed=1))
    code = _OnCard(torch.zeros(8, dtype=torch.int32), "cuda:1")
    K.pass_flags(code, None, _N_CODES, 0, EV_NULL)
    K.advance(eq, ob, cnt, _OnCard(torch.zeros(K.W_LEN, dtype=torch.int64),
                                   "cuda:1"), K.ADV_OPEN)
    K.advance_lanes(eq, ob, cnt, _OnCard(
        torch.zeros(2, K.W_LEN, dtype=torch.int64), "cuda:1"), _OnCard(
        torch.zeros(K.W_LEN + 1, dtype=torch.int64), "cuda:1"), K.ADV_OPEN)
    assert log == [("stream", "cuda:1"), ("sf_pass_flags", "cuda:1", 11),
                   ("stream", "cuda:1"), ("sf_advance", "cuda:1", 11),
                   ("stream", "cuda:1"), ("sf_advance_lanes", "cuda:1", 11)]
    assert K.LAUNCHES == {"pass_flags": 1, "advance": 1,
                          "advance_lanes": 1}
