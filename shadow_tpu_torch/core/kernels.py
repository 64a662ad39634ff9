"""The port's hand-written CUDA kernels and capture helpers, bound by ctypes.

``csrc/flow.cu`` builds with nvcc into one library with a plain C
interface (no PyTorch headers: seconds to build), kept on disk by
``serving.aotcache`` and loaded at first use (:func:`lib`). Nothing is
built or loaded when this module is imported.

Three kernels, each with its plain PyTorch version beside it and a
count of launches (:data:`LAUNCHES`, one a launch, counted only where
the wrapper launches):

- :func:`pass_flags` — the drain pass's dispatch bitmap and the pass
  loop's go-on flag (plain: :func:`pass_flags_plain`);
- :func:`advance` — the window boundary's reductions and the window
  scalars' update (plain: :func:`advance_plain`);
- :func:`advance_lanes` — ``advance`` over stacked scenario lanes, a
  row of window scalars a lane, and the batch's go-on flags (plain:
  :func:`advance_lanes_plain`).

A wrapper runs the plain version only when its tensors lie on the CPU
(or on the ``meta`` device, the tests' host-read guard); on a CUDA
tensor it launches the kernel or raises. It launches on its tensors'
card and that card's current stream, whichever card is current. The JAX package has no Pallas
kernel, so these replace none; they are what lets the window chunk run
as one captured CUDA graph (``core.flow``, ``core.jitcache``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import torch

from .simtime import SIMTIME_MAX

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "flow.cu")
ARCH = "sm_90a"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-cudart", "shared"]

# wrapper launches: one a launch on the card, a captured launch included
LAUNCHES = {"pass_flags": 0, "advance": 0, "advance_lanes": 0}

# the window-scalar vector W (int64), csrc/flow.cu's W_* indices
(W_WS, W_WE, W_I, W_PASSES, W_WEFF, W_RAN, W_OB0, W_CONT, W_STOP, W_JUMP,
 W_MAXW, W_EX, W_LEN) = range(13)
# advance modes: open the window W[W_WS, W_WE); after the drain, the
# exchange's packet count; the next window
ADV_OPEN, ADV_SHIP, ADV_STEP = 0, 1, 2

_LIB = None
_VP, _INT, _U64, _UINT = (ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_ulonglong, ctypes.c_uint)
_SIGS = {
    "sf_capture_begin": [_VP],
    "sf_capture_end": [_VP, ctypes.POINTER(_VP)],
    "sf_instantiate": [_VP, ctypes.POINTER(_VP)],
    "sf_launch": [_VP, _VP],
    "sf_destroy": [_VP, _VP],
    "sf_handle": [_VP, ctypes.POINTER(_U64)],
    "sf_set_cond": [_VP, _U64, _VP, _INT, _UINT],
    "sf_node_begin": [_VP, _VP, _U64, _INT],
    "sf_node_end": [_VP],
    "sf_pass_flags": [_VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT, _INT,
                      _VP, _U64],
    "sf_advance": [_VP, _VP, _VP, _VP, _INT, _VP, _INT, _U64],
    "sf_advance_lanes": [_VP, _VP, _VP, _VP, _INT, _INT, _VP, _VP, _INT,
                         _U64],
    "sf_exec_counts": [ctypes.POINTER(_U64), _INT],
    "sf_empty": [_VP, _INT, _INT],
}


def build(out: str):
    """nvcc ``csrc/flow.cu`` into the shared library `out`; raises with
    the compiler's output on failure."""
    from ..serving import aotcache
    cmd = [aotcache.nvcc_path()] + NVCC_FLAGS + ["-o", out, SOURCE]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"build of {SOURCE} failed: {e}") from e
    if r.returncode:
        raise RuntimeError(f"build of {SOURCE} failed ({' '.join(cmd)}):"
                           f"\n{r.stdout}{r.stderr}")


def lib():
    """The loaded library: from the disk tier, else built (nvcc) and
    published there. Raises when it cannot be built or loaded."""
    global _LIB
    if _LIB is None:
        from ..serving import aotcache
        path = aotcache.load_or_build(
            "flow", {"arch": ARCH, "flags": NVCC_FLAGS}, build)
        so = ctypes.CDLL(path)
        for name, args in _SIGS.items():
            fn = getattr(so, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _LIB = so
    return _LIB


def executions(reset: bool = False) -> dict:
    """How many times each kernel ran on the card (a captured chunk
    runs its kernels many times for each launch recorded in
    :data:`LAUNCHES`); `reset` zeroes the counts after reading them.
    Synchronizes."""
    out = (_U64 * len(LAUNCHES))()
    check(lib().sf_exec_counts(out, int(reset)), "read execution counts")
    return dict(zip(LAUNCHES, out))


def check(rc: int, what: str):
    """Raise on a non-zero cudaError_t from the library."""
    if rc:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def _stream(t) -> int:
    """The current stream of the card `t` lies on (not of the current
    card)."""
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_card(*ts) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU or meta
    tensors (the plain version)."""
    dev = ts[0].device.type
    if dev not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no kernel or plain version for {dev} tensors")
    return dev == "cuda"


def _need(t, dtype, what):
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what}: want a contiguous {dtype} tensor, "
                         f"got {t.dtype}")


# --- pass flags -------------------------------------------------------------

def pass_flags_plain(code, feat, n_codes: int, n_bits: int, null_code: int,
                     cont_mask: int, stop_mask: int):
    """[n_codes + n_bits + 1] int32: which codes and feature bits some
    row holds, then whether the pass loop goes on (some row's code is
    not `null_code` or has a bit of `cont_mask`, and none has a bit of
    `stop_mask`). `code` [H] int32 in [0, n_codes); `feat` [H] int32 bit
    words, or None."""
    dev = code.device
    present = torch.zeros(n_codes, dtype=torch.int32, device=dev)
    present.scatter_(0, code.to(torch.int64), 1)
    live = (code != null_code).any()
    if feat is None:
        bits = torch.zeros(n_bits, dtype=torch.int32, device=dev)
        word = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        bit = torch.arange(n_bits, dtype=torch.int32, device=dev)
        bits = ((feat[:, None] >> bit) & 1).amax(0) if feat.shape[0] else \
            torch.zeros(n_bits, dtype=torch.int32, device=dev)
        word = (bits << bit).sum(dtype=torch.int32)
    cont = ((live | ((word & cont_mask) != 0))
            & ((word & stop_mask) == 0)).to(torch.int32)
    return torch.cat([present, bits.to(torch.int32), cont.view(1)])


def pass_flags(code, feat, n_codes: int, n_bits: int, null_code: int,
               cont_mask: int = 0, stop_mask: int = 0, handle: int = 0):
    """:func:`pass_flags_plain` on the card; sets the conditional handle
    `handle` (a WHILE loop's, when not 0) to the go-on flag."""
    if not _on_card(code):
        return pass_flags_plain(code, feat, n_codes, n_bits, null_code,
                                cont_mask, stop_mask)
    _need(code, torch.int32, "pass_flags code")
    if feat is not None:
        _need(feat, torch.int32, "pass_flags feat")
    out = torch.empty(n_codes + n_bits + 1, dtype=torch.int32,
                      device=code.device)
    with torch.cuda.device(code.device):
        check(lib().sf_pass_flags(
            _stream(code), code.data_ptr(),
            None if feat is None else feat.data_ptr(), code.shape[0],
            n_codes, n_bits, null_code, cont_mask, stop_mask,
            out.data_ptr(), handle), "pass_flags launch")
    LAUNCHES["pass_flags"] += 1
    return out


# --- advance ----------------------------------------------------------------

def advance_plain(eq_next, ob_next, ob_cnt, W, mode: int):
    """The window boundary on the window scalars `W` ([W_LEN] int64,
    in place): ADV_OPEN opens W[W_WS, W_WE) (go-on flag, end clamped to
    the stop time, whether an event lies below it); ADV_SHIP records the
    outboxes' packet count and whether the exchange runs; ADV_STEP
    advances to the next window with the reference's anti-livelock
    rule, counts the window and opens the next one."""
    mq = eq_next.min()
    if mode == ADV_SHIP:
        so = ob_cnt.sum(dtype=torch.int64)
        W[W_OB0] = so
        W[W_EX] = (so > 0).to(torch.int64)
        return W
    if mode == ADV_STEP:
        so = ob_cnt.sum(dtype=torch.int64)
        progressed = (W[W_RAN] != 0) | (so < W[W_OB0])
        nt = torch.where(progressed, torch.minimum(mq, ob_next.min()), mq)
        W[W_WS] = nt
        W[W_WE] = torch.where(nt == SIMTIME_MAX, SIMTIME_MAX,
                              nt + W[W_JUMP])
        W[W_I] += 1
    ws = W[W_WS]
    W[W_CONT] = ((W[W_I] < W[W_MAXW]) & (ws < W[W_STOP])
                 & (ws < SIMTIME_MAX)).to(torch.int64)
    weff = torch.minimum(W[W_WE], W[W_STOP])
    W[W_WEFF] = weff
    W[W_RAN] = (mq < weff).to(torch.int64)
    return W


def advance(eq_next, ob_next, ob_cnt, W, mode: int, handle: int = 0):
    """:func:`advance_plain` on the card; ADV_OPEN and ADV_STEP set the
    conditional handle `handle` (the window loop's, when not 0) to the
    go-on flag."""
    if not _on_card(W):
        return advance_plain(eq_next, ob_next, ob_cnt, W, mode)
    _need(eq_next, torch.int64, "advance eq_next")
    _need(ob_next, torch.int64, "advance ob_next")
    _need(ob_cnt, torch.int32, "advance ob_cnt")
    _need(W, torch.int64, "advance W")
    with torch.cuda.device(W.device):
        check(lib().sf_advance(_stream(W), eq_next.data_ptr(),
                               ob_next.data_ptr(), ob_cnt.data_ptr(),
                               eq_next.shape[0], W.data_ptr(), mode,
                               handle), "advance launch")
    LAUNCHES["advance"] += 1
    return W


# --- advance over stacked lanes ---------------------------------------------

def advance_lanes_plain(eq_next, ob_next, ob_cnt, W, G, mode: int):
    """:func:`advance_plain` on each of B stacked lanes: the [B * H]
    rows, row r in lane r // H (H >= 1); `W` [B, W_LEN] int64, a row of
    window scalars a lane, in place. ADV_OPEN opens every lane; ADV_SHIP
    and ADV_STEP leave a lane whose W_CONT is 0 as it is (a frozen
    lane). `G` ([W_LEN + 1] int64, the batch's row) gets G[W_CONT], the
    OR of the lanes' go-on flags (ADV_OPEN, ADV_STEP), or G[W_EX],
    whether some live lane ships (ADV_SHIP); G[W_LEN] is the kernel's
    scratch."""
    B = W.shape[0]
    live = W[:, W_CONT] != 0
    if mode == ADV_SHIP:
        so = ob_cnt.view(B, -1).sum(1, dtype=torch.int64)
        W[:, W_OB0] = torch.where(live, so, W[:, W_OB0])
        W[:, W_EX] = torch.where(live, (so > 0).to(torch.int64),
                                 W[:, W_EX])
        G[W_EX] = (live & (W[:, W_EX] != 0)).any().to(torch.int64)
        return W
    mq = eq_next.view(B, -1).min(1).values
    new = W.clone()
    if mode == ADV_STEP:
        so = ob_cnt.view(B, -1).sum(1, dtype=torch.int64)
        progressed = (W[:, W_RAN] != 0) | (so < W[:, W_OB0])
        nt = torch.where(progressed, torch.minimum(
            mq, ob_next.view(B, -1).min(1).values), mq)
        new[:, W_WS] = nt
        new[:, W_WE] = torch.where(nt == SIMTIME_MAX, SIMTIME_MAX,
                                   nt + W[:, W_JUMP])
        new[:, W_I] += 1
    else:
        live = torch.ones_like(live)
    ws = new[:, W_WS]
    new[:, W_CONT] = ((new[:, W_I] < new[:, W_MAXW]) & (ws < new[:, W_STOP])
                      & (ws < SIMTIME_MAX)).to(torch.int64)
    weff = torch.minimum(new[:, W_WE], new[:, W_STOP])
    new[:, W_WEFF] = weff
    new[:, W_RAN] = (mq < weff).to(torch.int64)
    W.copy_(torch.where(live[:, None], new, W))
    G[W_CONT] = (W[:, W_CONT] != 0).any().to(torch.int64)
    return W


def advance_lanes(eq_next, ob_next, ob_cnt, W, G, mode: int,
                  handle: int = 0):
    """:func:`advance_lanes_plain` on the card; ADV_OPEN and ADV_STEP
    set the conditional handle `handle` (the window loop's, when not 0)
    to G[W_CONT]."""
    if not _on_card(W):
        return advance_lanes_plain(eq_next, ob_next, ob_cnt, W, G, mode)
    _need(eq_next, torch.int64, "advance_lanes eq_next")
    _need(ob_next, torch.int64, "advance_lanes ob_next")
    _need(ob_cnt, torch.int32, "advance_lanes ob_cnt")
    _need(W, torch.int64, "advance_lanes W")
    _need(G, torch.int64, "advance_lanes G")
    B = W.shape[0]
    if W.dim() != 2 or W.shape[1] != W_LEN or G.numel() != W_LEN + 1 \
            or eq_next.shape[0] % max(B, 1):
        raise ValueError(f"advance_lanes: W {tuple(W.shape)} (want [B, "
                         f"{W_LEN}]), G {tuple(G.shape)}, "
                         f"{eq_next.shape[0]} rows")
    with torch.cuda.device(W.device):
        check(lib().sf_advance_lanes(
            _stream(W), eq_next.data_ptr(), ob_next.data_ptr(),
            ob_cnt.data_ptr(), B, eq_next.shape[0] // B, W.data_ptr(),
            G.data_ptr(), mode, handle), "advance_lanes launch")
    LAUNCHES["advance_lanes"] += 1
    return W
