"""Port parity of the SACK scoreboard (net/sack.py).

Every op runs through ``jax.jit(jax.vmap(op))`` of the reference and
through the port's batched function on the same random rows (made by
numpy from a seed): canonical scoreboards (sorted, disjoint,
non-adjacent, empties last) as the TCP machine keeps them, plus raw
random rows. Tolerance zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from shadow_tpu.net import sack as RS

from shadow_tpu_torch.net import sack as PS

from torch_threads import one_torch_thread_everywhere  # noqa: F401

R = 4096
K = RS.K


def boards(seed):
    """[R, K] int64 (s, e): canonical scoreboards with 0..K ranges."""
    rng = np.random.RandomState(seed)
    s = np.full((R, K), -1, np.int64)
    e = np.full((R, K), -1, np.int64)
    for r in range(R):
        n = rng.randint(0, K + 1)
        pos = int(rng.randint(0, 5000))
        for j in range(n):
            pos += int(rng.randint(1, 3000))      # a gap: non-adjacent
            ln = int(rng.randint(1, 4000))
            s[r, j], e[r, j] = pos, pos + ln
            pos += ln
    return s, e


def scalars(seed, lo=-100, hi=30000):
    return np.random.RandomState(seed).randint(lo, hi, R).astype(np.int64)


def t(a):
    return torch.from_numpy(np.array(a))


def check(ref, got):
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        r, g = np.asarray(r), g.numpy()
        assert r.dtype == g.dtype and np.array_equal(r, g)


def test_insert_counted():
    for seed in (1, 2, 3):
        _insert_case(seed)


def _insert_case(seed):
    s, e = boards(seed)
    ns = scalars(seed + 10)
    ln = np.random.RandomState(seed).randint(-50, 5000, R).astype(np.int64)
    ne = ns + ln                                   # some empty (ne <= ns)
    check(jax.jit(jax.vmap(RS.insert_counted))(s, e, ns, ne),
          PS.insert_counted(t(s), t(e), t(ns), t(ne)))
    check(jax.jit(jax.vmap(RS.insert))(s, e, ns, ne),
          PS.insert(t(s), t(e), t(ns), t(ne)))


def test_consume_and_drop_below():
    for seed in (4, 5):
        _consume_case(seed)


def _consume_case(seed):
    s, e = boards(seed)
    x = scalars(seed + 20)
    check(jax.jit(jax.vmap(RS.consume))(s, e, x),
          PS.consume(t(s), t(e), t(x)))
    check(jax.jit(jax.vmap(RS.drop_below))(s, e, x),
          PS.drop_below(t(s), t(e), t(x)))


def test_queries():
    for seed in (6, 7):
        _queries_case(seed)


def _queries_case(seed):
    s, e = boards(seed)
    x = scalars(seed + 30)
    hole = scalars(seed + 40, 0, 40000)
    check(jax.jit(RS.skip)(x, s, e), PS.skip(t(x), t(s), t(e)))
    check(jax.jit(RS.next_start_after)(x, s, e),
          PS.next_start_after(t(x), t(s), t(e)))
    check(jax.jit(RS.max_end)(s, e), PS.max_end(t(s), t(e)))
    check(jax.jit(jax.vmap(RS.lost_bound))(s, e, x, hole),
          PS.lost_bound(t(s), t(e), t(x), t(hole)))


def test_wire_encoding():
    for seed in (8, 9):
        _wire_case(seed)


def _wire_case(seed):
    s, e = boards(seed)
    ack = scalars(seed + 50, 0, 8000)
    check(jax.jit(jax.vmap(RS.encode2))(s, e, ack),
          PS.encode2(t(s), t(e), t(ack)))
    rng = np.random.RandomState(seed)
    word = rng.randint(-2**31, 2**31, R, dtype=np.int64).astype(np.int32)
    word[: R // 2] = np.asarray(jax.jit(jax.vmap(RS.encode2))(s, e, ack)[0]
                                )[: R // 2]
    hi = ack + rng.randint(-100, 10**6, R)
    check(jax.jit(jax.vmap(RS.decode))(word, ack, hi),
          PS.decode(t(word), t(ack), t(hi)))


def test_raw_rows():
    """Rows outside the canonical form (unsorted, overlapping, empties
    anywhere) still give the reference's answer."""
    rng = np.random.RandomState(11)
    s = rng.randint(-1, 3000, (R, K)).astype(np.int64)
    e = s + rng.randint(-5, 900, (R, K))
    x = scalars(12, -10, 4000)
    ne = x + rng.randint(-20, 900, R)
    for fn, args in (("insert_counted", (s, e, x, ne)),
                     ("consume", (s, e, x)), ("drop_below", (s, e, x))):
        check(jax.jit(jax.vmap(getattr(RS, fn)))(*args),
              getattr(PS, fn)(*[t(a) for a in args]))
