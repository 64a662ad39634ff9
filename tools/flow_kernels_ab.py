"""Time the chunk kernels (``shadow_tpu_torch/csrc/flow.cu``) against
other sources of them on one card, in one process.

    python3 tools/flow_kernels_ab.py OTHER.cu [OTHER.cu ...]

Each OTHER.cu has ``csrc/flow.cu``'s C interface for pass_flags and
advance: an earlier ``flow.cu`` (e.g. unpacked from a parent commit with
``git archive``) or a variant of this one. Each is built with
``core/kernels.py``'s nvcc flags into ``build/kernels/ab/``; it and the
shipped library are held bit-equal to the plain versions as
``chip_smoke.py`` phase 30 holds the shipped one (every CHECK_ROWS count,
contiguous and one element in, and 64 executions in one graph), then
timed inside a CUDA graph (``chip_smoke._graph_ms``: 200 launches a
graph) at each KERNEL_ROWS count, the builds in the order a, b, ..., b,
a. Prints the card's name and power limit, then one JSON line a build:
its ms a launch of each kernel at each row count, each turn's and their
mean. A build that fails its check is named, left out of the timing,
and makes the exit code 1. Needs a CUDA card and nvcc.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from shadow_tpu_torch.core import kernels as K  # noqa: E402
from shadow_tpu_torch.serving import aotcache  # noqa: E402


def build(i, source):
    """nvcc `source` as ``core/kernels.py`` builds ``csrc/flow.cu`` ->
    the library, with its two kernels' and counters' signatures."""
    d = os.path.join(ROOT, "build", "kernels", "ab")
    os.makedirs(d, exist_ok=True)
    out = os.path.join(d, f"flow_{i}.so")
    subprocess.run([aotcache.nvcc_path()] + K.NVCC_FLAGS
                   + ["-o", out, source], check=True)
    so = ctypes.CDLL(out)
    for name in ("sf_pass_flags", "sf_advance", "sf_exec_counts"):
        getattr(so, name).argtypes = K._SIGS[name]
        getattr(so, name).restype = ctypes.c_int
    return so


def check():
    """The current build against the plain versions, as phase 30 ->
    what failed, or None."""
    try:
        for H in C.CHECK_ROWS:
            for offset in (0, 1):
                err = C._kernel_errors(K, H, H + offset, offset)
                if any(err):
                    return f"kernel != plain at H={H} offset={offset}: {err}"
        err = C._graph_errors(K)
    except RuntimeError as e:       # a refused launch
        return str(e)
    return f"kernel != plain in a graph: {err}" if any(err) else None


def main(argv):
    if not torch.cuda.is_available():
        sys.stderr.write("flow_kernels_ab: no CUDA device\n")
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    libs = {"shipped": K.lib()}
    for i, src in enumerate(argv):
        libs[os.path.relpath(os.path.abspath(src), ROOT)] = build(i, src)
    bad = False
    for name, lib in list(libs.items()):
        K._LIB = lib            # the wrappers launch this build's kernels
        err = check()
        if err:
            print(json.dumps({"build": name, "failed": err}), flush=True)
            del libs[name]
            bad = True
    order = list(libs) + list(libs)[::-1]
    turns = {n: {H: {"pass_flags": [], "advance": []}
                 for H in C.KERNEL_ROWS} for n in libs}
    for H in C.KERNEL_ROWS:
        code, feat, eq, ob, cnt = C._kernel_inputs(H, H)
        args = C._flag_args(code, feat, 0)
        for name in order:
            K._LIB = libs[name]
            W = C._window_in(K)
            t = turns[name][H]
            t["pass_flags"].append(C._graph_ms(lambda: K.pass_flags(*args)))
            t["advance"].append(C._graph_ms(
                lambda: K.advance(eq, ob, cnt, W, K.ADV_STEP)))
    for name, by_rows in turns.items():
        print(json.dumps({"build": name, "graph_ms": {
            H: {k: {"turns": [round(x, 6) for x in v],
                    "mean": round(sum(v) / len(v), 6)}
                for k, v in t.items()}
            for H, t in by_rows.items()}}), flush=True)
    K._LIB = libs.get("shipped")
    K.LAUNCHES.update(pass_flags=0, advance=0)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
