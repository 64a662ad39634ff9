"""Multi-device execution: the window loop over a mesh of host shards.

Counterpart of ``shadow_tpu/parallel/``. :mod:`shard` block-shards the
hosts over a mesh of torch devices and runs the window loop with a
sharded exchange, bit-identical to the single-device run;
:mod:`dist` spans one mesh over several processes through
``torch.distributed``.
"""

from .shard import make_mesh, run_windows_sharded

__all__ = ["make_mesh", "run_windows_sharded"]
