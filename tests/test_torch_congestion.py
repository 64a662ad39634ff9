"""Port parity of the TCP congestion control (net/congestion.py).

``on_ack``/``on_loss`` for aimd, reno and cubic, and the float32 cbrt
of the cubic's K, against ``jax.jit`` of the reference functions on
the CPU: random socket-state vectors from a numpy seed, tolerance zero.
The reference's golden hand vectors (tests/test_golden_tcp.py) run
against the port's functions too.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.net import congestion as RCC

import test_golden_tcp as G
from shadow_tpu_torch.net import congestion as CC
from shadow_tpu_torch.net import sack as SACK

N = 1 << 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def socket_vectors(seed):
    """(cwnd, ssthresh, wmax, epoch, k, npkts, now, srtt_ns): slow start
    and avoidance, fresh and running epochs, wmax unset/above/below."""
    rng = np.random.RandomState(seed)
    cw = (rng.choice([1, 2, 10, 37.5, 100, 1000], N)
          * rng.uniform(0.5, 2, N)).astype(np.float32)
    ss = np.where(rng.rand(N) < 0.3, 0,
                  cw * rng.uniform(0.3, 1.5, N)).astype(np.float32)
    wm = np.where(rng.rand(N) < 0.3, 0,
                  cw * rng.uniform(0.5, 2, N)).astype(np.float32)
    ep = np.where(rng.rand(N) < 0.5, -1,
                  rng.randint(0, 10**10, N)).astype(np.int64)
    k = rng.uniform(0, 5, N).astype(np.float32)
    npk = rng.randint(0, 50, N).astype(np.int64)
    now = (ep.clip(0) + rng.randint(0, 2 * 10**10, N)).astype(np.int64)
    srtt = np.where(rng.rand(N) < 0.2, -1,
                    rng.randint(1, 10**9, N)).astype(np.int64)
    return cw, ss, wm, ep, k, npk, now, srtt


def _bits_equal(ref, got):
    ref = np.ascontiguousarray(np.broadcast_to(np.asarray(ref), got.shape))
    return ref.dtype == got.dtype and np.array_equal(
        ref.view(np.uint8), np.ascontiguousarray(got).view(np.uint8))


@pytest.mark.parametrize("kind", [RCC.CC_AIMD, RCC.CC_RENO, RCC.CC_CUBIC],
                         ids=["aimd", "reno", "cubic"])
def test_on_ack_and_on_loss_bit_equal(kind):
    for seed in (1, 2):
        v = socket_vectors(seed)
        tv = [torch.from_numpy(a) for a in v]
        tk = torch.tensor(kind, dtype=torch.int32)
        ref = jax.jit(RCC.on_ack)(jnp.int32(kind), *v)
        got = CC.on_ack(tk, *tv)
        for name, r, g in zip(("cwnd", "epoch", "k"), ref, got):
            assert _bits_equal(r, g.numpy()), (seed, name)
        ref = jax.jit(RCC.on_loss)(jnp.int32(kind), *v[:3])
        got = CC.on_loss(tk, *tv[:3])
        for name, r, g in zip(("cwnd", "ssthresh", "wmax", "epoch"), ref,
                              got):
            assert _bits_equal(r, g.numpy()), (seed, name)


def cbrt_inputs():
    """2^20 values spread over the cubic's domain (2^-20 .. 2^20), plus
    0, -0, the binade edges, the float32 extremes and inf/NaN."""
    rng = np.random.RandomState(5)
    x = (2.0 ** rng.uniform(-20, 20, 1 << 20)).astype(np.float32)
    edges = (2.0 ** np.arange(-40, 41)).astype(np.float32)
    special = np.array([0.0, -0.0, -8.0, 1.1754944e-38, 1e-40, 3.4e38,
                        np.inf, -np.inf, np.nan], np.float32)
    return np.concatenate([x, edges, np.nextafter(edges, 0),
                           np.nextafter(edges, np.inf), special])


def test_cbrt_bit_equal_to_xla():
    x = cbrt_inputs()
    ref = np.asarray(jax.jit(jnp.cbrt)(x))
    got = CC.cbrt_f32(torch.from_numpy(x)).numpy()
    nan = np.isnan(ref) & np.isnan(got)
    bad = (ref.view(np.int32) != got.view(np.int32)) & ~nan
    assert not bad.any(), (x[bad][:8], ref[bad][:8], got[bad][:8])


def test_fma_f64_is_correctly_rounded():
    """The emulated double fma equals exact rational arithmetic."""
    from fractions import Fraction
    rng = np.random.RandomState(9)
    a = rng.randn(4000) * rng.choice([1, 1e-5, 1e5], 4000)
    b = rng.randn(4000)
    c = rng.randn(4000) * rng.choice([1, 1e-10, 1e10], 4000)
    got = CC.fma_f64(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(c)).numpy()
    want = [float(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(a, b, c)]
    assert np.array_equal(got, np.array(want))


# --- the reference's golden hand vectors on the port ------------------------

def _to_torch(x):
    return torch.as_tensor(np.array(x))


def _to_np(out):
    if isinstance(out, tuple):
        return tuple(_to_np(o) for o in out)
    return out.numpy() if torch.is_tensor(out) else out


def _adapt(fn):
    def call(*args):
        return _to_np(fn(*[_to_torch(a) for a in args]))
    return call


PORT_CC = types.SimpleNamespace(
    CC_AIMD=CC.CC_AIMD, CC_RENO=CC.CC_RENO, CC_CUBIC=CC.CC_CUBIC,
    on_ack=_adapt(CC.on_ack), on_loss=_adapt(CC.on_loss))
PORT_SACK = types.SimpleNamespace(
    K=SACK.K,
    empty=lambda: (np.full(SACK.K, -1, np.int64),
                   np.full(SACK.K, -1, np.int64)),
    **{name: _adapt(getattr(SACK, name)) for name in (
        "insert", "insert_counted", "consume", "drop_below", "skip",
        "next_start_after", "max_end", "lost_bound", "encode2", "decode")})

# every golden test but the cubic trajectory, whose driver scans the
# reference kernel under jax.jit (the port's cubic is held bit-equal to
# that kernel above)
GOLDEN = [getattr(G, n) for n in sorted(dir(G))
          if n.startswith("test_") and n != "test_cubic_trajectory_vs_"
          "reference_mechanics"]


@pytest.mark.parametrize("part", ["congestion", "sack"])
def test_golden_vectors_on_port(part, monkeypatch):
    """Each golden test of that module part, with the port's functions
    in place of the reference's."""
    monkeypatch.setattr(G, "CC", PORT_CC)
    monkeypatch.setattr(G, "sack", PORT_SACK)
    tests = [g for g in GOLDEN
             if ("sack" in g.__name__ or "lost_bound" in g.__name__
                 or "encode" in g.__name__ or "retransmit" in g.__name__)
             == (part == "sack")]
    assert tests
    for golden in tests:
        golden()
