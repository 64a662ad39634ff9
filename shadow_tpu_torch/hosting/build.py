"""The hosting tier's native builds: one directory, built at first use.

The LD_PRELOAD shim (``shim_preload.c``), native C plugins and any
helper binary a script compiles go into :func:`build_dir`:
``$SHADOW_TPU_TORCH_BUILD`` when set, else ``build/hosting`` at the root
of the checkout (listed in ``.gitignore``). The reference package builds
elsewhere, so neither package ever LD_PRELOADs the other's build.

Safety rules, kept from the reference's ``build_shim``: the directory is
created owner-only (0700), and a cached artifact is reused only if this
user owns it, it is not group- or world-writable and it is newer than
its source. A build writes a temporary file and renames it into place,
so a concurrent reader never loads a half-written library. A failed
build raises ``RuntimeError`` with the compiler's output: there is no
fallback.
"""

from __future__ import annotations

import os
import subprocess

BUILD_ENV = "SHADOW_TPU_TORCH_BUILD"
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_dir() -> str:
    """The build directory (created owner-only on first use)."""
    d = os.environ.get(BUILD_ENV) or os.path.join(_ROOT, "build", "hosting")
    os.makedirs(d, mode=0o700, exist_ok=True)
    return d


def _reusable(out: str, src: str) -> bool:
    if not os.path.exists(out):
        return False
    st = os.stat(out)
    return (st.st_mtime >= os.path.getmtime(src)
            and st.st_uid == os.getuid() and not st.st_mode & 0o022)


def compile_c(cmd: list, out: str, src: str) -> str:
    """Run compiler `cmd` (its output file last) into `out` unless a
    reusable build of `src` is there -> `out`."""
    if _reusable(out, src):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(cmd + [tmp], capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"build of {out} failed ({' '.join(cmd)}):"
                               f"\n{r.stderr}")
        os.chmod(tmp, 0o755)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
