"""Control flow of the window chunk: read on the host, or captured.

The reference runs a chunk of windows as one compiled program: a
``lax.while_loop`` over windows, the drain's loop over passes inside
it, the exchange behind a ``lax.cond`` (``shadow_tpu/engine/window.py``
``_run_windows_impl``). The port writes that control flow once, against
the current flow (:func:`cur`), which has two implementations:

- :class:`EagerFlow` reads each predicate on the host and runs Python's
  own ``if``/``while``: the plain loop, used on the CPU and on the eager
  paths (hosted apps, a mesh over several cards or processes, passcope,
  ``graph=False``);
- :class:`GraphFlow` records CUDA graph conditional nodes while the
  chunk is captured (``core.jitcache``): ``while_`` adds a WHILE node
  and ``if_`` an IF node, each set on the device from its predicate
  tensor, so the captured chunk reads nothing on the host.

The operations:

- ``if_(pred, body)`` — run `body` where `pred` holds. A Python bool is
  a decision the configuration fixed, the same under both flows (no
  node); a tensor is a device scalar. :func:`when` is the decorator
  form.
- ``while_(first, body)`` — while `first` (then each of `body`'s
  results) holds, run `body`. A body that set the loop's handle itself
  (a kernel given :func:`loop_handle`) returns ``result(pred)``.
- ``read(vec, possible)`` — the predicates of an int vector: a list of
  Python bools under EagerFlow (one host read, counted in
  :data:`STATS`), of device scalars (views) under GraphFlow; an entry
  that ``possible`` rules out is False under both.
- :func:`count` — a device counter add.

A captured body reads and writes the addresses it saw at capture, so
everything a body hands to code after it is written in place into a
tensor made before it.

:class:`TraceFlow` runs every body once without reading a predicate,
as capture does: the CPU tests run the chunk under it on the ``meta``
device to show that nothing inside reads the host.
"""

from __future__ import annotations

import contextlib

import torch

# host reads made by EagerFlow (predicates) and by the graph path's one
# read of the window scalars a chunk (core.jitcache)
STATS = {"host_reads": 0}


def _is_static(pred) -> bool:
    return isinstance(pred, (bool, int))


class EagerFlow:
    """The plain loop: every predicate is read on the host."""

    graph = False
    path = ()

    def read(self, vec, possible=None):
        STATS["host_reads"] += 1
        vals = vec.tolist()
        return [bool(v) and (possible is None or possible[i])
                for i, v in enumerate(vals)]

    def _bool(self, pred) -> bool:
        if _is_static(pred):
            return bool(pred)
        STATS["host_reads"] += 1
        return bool(pred)

    def if_(self, pred, body):
        if self._bool(pred):
            body()

    def while_(self, first, body):
        go = self._bool(first)
        while go:
            go = self._bool(body())

    def loop_handle(self) -> int:
        return 0

    def result(self, pred):
        return pred


class _Bodies:
    """The stack of bodies being recorded (:func:`body_path`)."""

    def __init__(self):
        self.path = ()
        self._n = 0

    @contextlib.contextmanager
    def _body(self):
        self._n += 1
        outer, self.path = self.path, self.path + (self._n,)
        try:
            yield
        finally:
            self.path = outer


class TraceFlow(_Bodies):
    """Every body runs once and no predicate is read, as capture does
    (the CPU host-read guard)."""

    graph = True

    def read(self, vec, possible=None):
        return [vec[i] if possible is None or possible[i] else False
                for i in range(vec.shape[0])]

    def _check(self, pred):
        if not (_is_static(pred) or torch.is_tensor(pred)):
            raise TypeError(f"a predicate is a bool or a tensor, not "
                            f"{type(pred).__name__}")

    def if_(self, pred, body):
        self._check(pred)
        if _is_static(pred):
            if pred:
                body()
            return
        with self._body():
            body()

    def while_(self, first, body):
        self._check(first)
        if _is_static(first) and not first:
            return
        with self._body():
            p = body()
        if p is not None:
            self._check(p)

    def loop_handle(self) -> int:
        return 0

    def result(self, pred):
        return pred


class GraphFlow(_Bodies):
    """Conditional nodes recorded into the graph being captured on the
    current stream. Bodies are captured on one child stream per nesting
    depth; the caller routes every allocation of the capture to the
    graph's memory pool (``core.jitcache``)."""

    graph = True

    def __init__(self, device):
        super().__init__()
        from . import kernels
        self.K = kernels
        self.lib = kernels.lib()
        self.device = device
        self._children = []
        self._depth = 0
        self._loops = []
        self.nodes = {"while": 0, "if": 0}

    read = TraceFlow.read

    def _s(self) -> int:
        return torch.cuda.current_stream(self.device).cuda_stream

    def _handle(self) -> int:
        import ctypes
        h = ctypes.c_ulonglong(0)
        self.K.check(self.lib.sf_handle(self._s(), ctypes.byref(h)),
                     "conditional handle")
        return h.value

    def _set(self, h: int, pred):
        if _is_static(pred):
            rc = self.lib.sf_set_cond(self._s(), h, None, 0, int(bool(pred)))
        else:
            if pred.numel() != 1 or pred.device.type != "cuda":
                raise ValueError("a captured predicate is one element on "
                                 "the card")
            rc = self.lib.sf_set_cond(self._s(), h, pred.data_ptr(),
                                      pred.element_size(), 0)
        self.K.check(rc, "set conditional")

    @contextlib.contextmanager
    def _node(self, h: int, is_while: bool):
        while len(self._children) <= self._depth:
            self._children.append(torch.cuda.Stream(self.device))
        child = self._children[self._depth]
        self.K.check(self.lib.sf_node_begin(self._s(), child.cuda_stream, h,
                                            int(is_while)),
                     "conditional node")
        self.nodes["while" if is_while else "if"] += 1
        self._depth += 1
        try:
            with torch.cuda.stream(child), self._body():
                yield
        finally:
            self._depth -= 1
            self.K.check(self.lib.sf_node_end(child.cuda_stream),
                         "conditional body capture")

    def if_(self, pred, body):
        if _is_static(pred):
            if pred:
                body()
            return
        h = self._handle()
        self._set(h, pred)
        with self._node(h, False):
            body()

    def while_(self, first, body):
        if _is_static(first) and not first:
            return
        h = self._handle()
        self._set(h, first)
        self._loops.append(h)
        try:
            with self._node(h, True):
                p = body()
                if p is not None:
                    self._set(h, p)
        finally:
            self._loops.pop()

    def loop_handle(self) -> int:
        return self._loops[-1] if self._loops else 0

    def result(self, pred):
        return None         # the body's kernel set the loop's handle


_FLOWS = [EagerFlow()]


def cur():
    """The current flow (EagerFlow unless a chunk is being captured or
    traced)."""
    return _FLOWS[-1]


@contextlib.contextmanager
def using(flow):
    _FLOWS.append(flow)
    try:
        yield flow
    finally:
        _FLOWS.pop()


def body_path() -> tuple:
    """The ids of the captured or traced bodies being recorded, outermost
    first (() under the eager flow): a value made in a body may be
    reused only where this path extends the one it was made under."""
    return cur().path


def when(pred):
    """Decorator: run the function now, under ``if_(pred)``; the name
    it decorates is bound to None."""
    def deco(fn):
        cur().if_(pred, fn)
    return deco


def read(vec, possible=None):
    return cur().read(vec, possible)


def loop_handle() -> int:
    return cur().loop_handle()


def result(pred):
    return cur().result(pred)


def any_of(*preds):
    """The OR of predicates: static where every one is, else a device
    scalar."""
    dyn = [p for p in preds if not _is_static(p)]
    if any(_is_static(p) and p for p in preds):
        return True
    if not dyn:
        return False
    out = dyn[0]
    for p in dyn[1:]:
        out = out | p
    return out


def count(counter, inc):
    """counter += inc on the device (in place)."""
    counter.add_(inc)
