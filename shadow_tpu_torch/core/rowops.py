"""Per-row slot access on batched state.

The reference's handlers are row-level functions under ``vmap``, and
``shadow_tpu/core/rowops.py`` writes a row's slot with one-hot selects
because XLA:TPU scatters do not fuse. Here every function takes all
rows at once: ``arr`` is ``[H, N, ...]`` and a :class:`Slot` holds one
slot index per row (``idx`` ``[H]``). There is one form per access:

- a read is one ``gather`` along dim 1 (``Slot.get``, ``rget``);
- a write is one masked select over the whole ``[H, N, ...]`` array
  against a ``[H, N]`` one-hot (``Slot.mask`` then ``mput``,
  ``rset_where``, ``radd_where``): one launch per written array once
  the one-hot exists, where a gather/select/scatter takes three. More
  bytes for fewer launches: a drain pass spends more host time on
  launches than device time on these selects.

Writes are in place and masked: a row changes only where its ``cond``
holds. Out-of-range slots behave as the reference's one-hot form: a
read returns zeros and a write is dropped. A handler that touches
several arrays at one slot builds its ``Slot`` once.
"""

from __future__ import annotations

from functools import cached_property

import torch


def _bcast(mask, like):
    """[H] mask broadcast against a [H, ...] row value."""
    return mask.view((mask.shape[0],) + (1,) * (like.dim() - 1))


def _trail(mask, arr):
    """[H, N] mask viewed against a [H, N, ...] array."""
    return mask.view(mask.shape + (1,) * (arr.dim() - 2))


class Slot:
    """One slot index per row (``idx`` [H]) into tables of width ``n``.
    Each derived index is built on first use only."""

    def __init__(self, idx, n: int):
        self.idx = idx
        self.n = n

    @cached_property
    def ok(self):
        return (self.idx >= 0) & (self.idx < self.n)

    @cached_property
    def ix(self):
        return self.idx.to(torch.int64).clamp(0, self.n - 1).unsqueeze(1)

    @cached_property
    def oh(self):
        # out-of-range rows match nothing: their writes are dropped
        return (torch.arange(self.n, device=self.idx.device)
                == self.idx.unsqueeze(1))

    def get(self, arr):
        """arr[h, idx[h]] per row (zeros out of range)."""
        ix = self.ix
        if arr.dim() > 2:
            ix = ix.view(ix.shape + (1,) * (arr.dim() - 2)).expand(
                (arr.shape[0], 1) + tuple(arr.shape[2:]))
        v = arr.gather(1, ix).squeeze(1)
        return torch.where(_bcast(self.ok, v), v,
                           False if arr.dtype == torch.bool else 0)

    def mask(self, m):
        """[H, N] write mask: the slot of each row where m holds."""
        return self.oh & m.unsqueeze(1)


def mput(arr, w, val):
    """arr[h, j] = val[h] where the [H, N] write mask w[h, j] holds (in
    place; `val` a python scalar, a 0-d or a per-row tensor)."""
    wb = _trail(w, arr)
    if not torch.is_tensor(val):
        arr.masked_fill_(wb, val)
        return
    val = val.to(arr.dtype)
    if val.dim() > 0:
        val = val.unsqueeze(1)
    torch.where(wb, val, arr, out=arr)


def rget(arr, idx):
    """arr[h, idx[h]] for every row h -> [H, ...] (zeros out of range)."""
    return Slot(idx, arr.shape[1]).get(arr)


def rset_where(arr, idx, cond, val):
    """arr[h, idx[h]] = val[h] where cond[h] (in place)."""
    mput(arr, Slot(idx, arr.shape[1]).mask(cond), val)


def radd_where(arr, idx, cond, val):
    """arr[h, idx[h]] += val[h] where cond[h] (in place)."""
    sl = Slot(idx, arr.shape[1])
    mput(arr, sl.mask(cond), sl.get(arr) + val)


def col_add(arr, col: int, cond, val=1):
    """arr[h, col] += val where cond[h] (in place; [H, N] arrays)."""
    arr[:, col] += torch.where(cond, val, 0).to(arr.dtype)


def set_where(arr, cond, val):
    """arr[h] = val[h] where cond[h] (in place; [H] arrays)."""
    arr.copy_(torch.where(cond, val, arr))
