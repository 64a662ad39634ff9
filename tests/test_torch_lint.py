"""The determinism lint over the port: ``shadow_tpu/lint``'s
``determinism.check_source`` on every ``shadow_tpu_torch/**/*.py``,
loaded the way ``tools/simlint`` loads it (without importing the
``shadow_tpu`` package or jax). The port keeps its own allowlist: the
wall-clock reads that measure or schedule runs and never feed
simulated time. The lint's own SCOPE names the JAX package only and is
not changed; the tracing and stateflow rules are jax-specific and not
applied."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# rule -> {port file: why its wall-clock reads are not sim state}
PORT_ALLOW = {
    "DET101": {
        "shadow_tpu_torch/obs/trace.py":
            "the span recorder: perf_counter is the product",
        "shadow_tpu_torch/obs/logger.py": "log line wall stamps",
        "shadow_tpu_torch/obs/digest.py":
            "times its own record() calls for the durability report",
        "shadow_tpu_torch/engine/supervisor.py":
            "attempt walls for the crash journal",
        "shadow_tpu_torch/engine/sim.py":
            "the run's wall and chunk walls for SimReport and metrics",
        "shadow_tpu_torch/serving/batch.py":
            "the batch wall for the lanes' reports",
        "shadow_tpu_torch/fleet/queue.py":
            "journal stamps and claim mtimes (queue bookkeeping)",
        "shadow_tpu_torch/fleet/scheduler.py":
            "backoff, lock takeover and reap timing",
        "shadow_tpu_torch/fleet/worker.py":
            "the progress watchdog compares wall mtimes",
        "shadow_tpu_torch/core/jitcache.py":
            "capture walls for STATS and the jitcache.compile span",
        "shadow_tpu_torch/serving/aotcache.py":
            "build and load walls, and stale publish-lock ages",
        "shadow_tpu_torch/serving/prewarm.py":
            "probe and warm children's deadlines",
    },
}

_RUN = r"""
import json, pathlib, sys
sys.path.insert(0, sys.argv[1])
from tools.simlint import load
load()
from shadow_tpu.lint import core, determinism
out = []
root = pathlib.Path(sys.argv[1])
for p in sorted((root / "shadow_tpu_torch").rglob("*.py")):
    rel = p.relative_to(root).as_posix()
    text = p.read_text()
    lines = text.splitlines()
    vs = determinism.check_source(rel, text)
    active, _n, extra = core.apply_suppressions(vs, lambda _r: lines)
    out += [[v.rule, v.file, v.line, v.message] for v in active + extra]
print(json.dumps({"violations": out, "scope": determinism.SCOPE,
                  "planted": [v.rule for v in determinism.check_source(
                      "x.py", "import time, random\nt = time.time()\n"
                      "random.random()\n")],
                  "jax": "jax" in sys.modules,
                  "shadow_tpu": "shadow_tpu" in sys.modules}))
"""


def lint_port():
    out = subprocess.run([sys.executable, "-c", _RUN, str(REPO)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


def test_port_is_deterministic_under_its_allowlist():
    """No determinism finding outside the allowlist, every allowlisted
    file still needs its entry, and the loader pulled in neither jax
    nor the shadow_tpu package."""
    res = lint_port()
    assert not res["jax"] and not res["shadow_tpu"]
    left = [v for v in res["violations"]
            if v[1] not in PORT_ALLOW.get(v[0], {})]
    assert not left, "\n".join(f"{r} {f}:{ln} {m}" for r, f, ln, m in left)
    used = {(v[0], v[1]) for v in res["violations"]}
    stale = [(r, f) for r, files in PORT_ALLOW.items() for f in files
             if (r, f) not in used]
    assert not stale, f"allowlist entries no longer needed: {stale}"


def test_lint_catches_a_planted_hazard_and_scope_is_the_reference():
    """The check is live (a planted wall-clock read and a module-global
    random draw are flagged) and its SCOPE names the JAX package only:
    the port is linted through this test, not through the lint's own
    scope."""
    res = lint_port()
    assert res["planted"] == ["DET101", "DET102"]
    assert all(s.startswith("shadow_tpu/") for s in res["scope"])
