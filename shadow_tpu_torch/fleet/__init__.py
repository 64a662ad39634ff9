"""Fleet: a crash-safe sweep scheduler over the durable-run substrate.

Counterpart of ``shadow_tpu/fleet/`` (a copy: that package sits under
``shadow_tpu``, whose import loads jax). The children are
``python -m shadow_tpu_torch`` runs and batches, on the card unless a
submit says ``--device cpu``.

One run survives any crash through engine.supervisor,
engine.checkpoint and the digest rewind. This package generalizes that
from one run to a fleet: a durable on-disk
run queue (queue), a worker slot that executes each run as a
supervised child process (worker), and a scheduler that drains the
queue through crashes of the runs AND of itself (scheduler).

Guarantees (docs/fleet.md, proven by tests/test_fleet.py):

- **durable**: every queue transition is one fsync'd JSONL journal
  line (torn-line tolerant — obs.ledger); claims are O_EXCL files;
  SIGKILLing workers and the scheduler at arbitrary instants loses no
  run and duplicates no result;
- **equivalent**: a sweep interrupted anywhere completes on restart
  with every run's digest chain byte-identical to an uninterrupted
  reference sweep — and the chains
  are independent of worker count and scheduling order;
- **isolated**: a deterministic crasher is retried with exponential
  backoff and then QUARANTINED with its crash-cause journal, while
  the rest of the queue keeps draining;
- **bounded**: admission control caps concurrent simulated hosts /
  declared RSS, so an oversized scenario waits as "queued" instead of
  OOMing the box (it runs alone once the box is free);
- **preemptible**: SIGTERM makes workers checkpoint at the next chunk
  boundary (engine.sim.Preempted, exit 75) and requeues their runs as
  resumable — scheduler restart ≡ uninterrupted sweep.

CLI: ``python -m shadow_tpu_torch fleet submit|run|status`` (fleet.cli).
"""

from .queue import Queue, RunState  # noqa: F401
from .scheduler import Scheduler    # noqa: F401
