"""One mesh over several processes: ``torch.distributed``.

Counterpart of ``shadow_tpu/parallel/dist.py``, the reference's
multi-slave design (SURVEY §2.9 item 6): every process builds the same
scenario (deterministic, so all agree on tables and seeds), keeps its
own shards of one global mesh and runs the same window loop; the
collectives of ``parallel.shard`` ride ``torch.distributed`` between
the processes. Usage, one call per process before building the
Simulation:

    from shadow_tpu_torch.parallel import dist
    dist.init("host0:29500", num_processes=2, process_id=i,
              local_shards=2)
    report = Simulation(scenario).run(mesh=dist.global_mesh())

The shards live on ``device`` (``cuda`` unless the caller names
another). The backend is ``nccl`` for CUDA state and ``gloo`` for CPU
state, unless the caller names one. NCCL refuses two ranks on one card,
so on a one-card machine the caller passes ``backend="gloo"`` with CUDA
state; nothing switches backend on its own. gloo takes CPU tensors: a CUDA
buffer is copied to host memory for each collective and back, and those
bytes are counted (``SimReport.mesh["host_staged_bytes"]``, beside the
backend the run used).
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

_STATE = None
# how long a process waits for its peers, at the join and in a collective
TIMEOUT = datetime.timedelta(seconds=600)


class Distributed:
    """The collectives of ``parallel.shard`` over ``torch.distributed``:
    `local` shards per process, all on this process's `device`; shard
    ``rank * local + k`` is local shard k of process `rank`."""

    multiprocess = True

    def __init__(self, rank: int, world: int, local: int, device,
                 backend: str):
        self.rank, self.world, self.local = rank, world, local
        self.device = torch.device(device)
        self.backend = backend
        # gloo takes host tensors: CUDA buffers go through host memory
        self.stage = backend == "gloo" and self.device.type == "cuda"
        self.staged_bytes = 0

    def _wire(self, x):
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        if self.stage:
            self.staged_bytes += x.numel() * x.element_size()
            x = x.cpu()
        return x.contiguous()

    def _unwire(self, x, dtype, device):
        if self.stage:
            self.staged_bytes += x.numel() * x.element_size()
        return x.to(device=device, dtype=dtype)

    def _gather(self, x):
        """Each rank's `x` (same shape everywhere), in rank order."""
        import torch.distributed as tdist
        w = self._wire(x)
        outs = [torch.empty_like(w) for _ in range(self.world)]
        tdist.all_gather(outs, w)
        return self._unwire(torch.cat(outs), x.dtype, self.device)

    def scalars(self, vals):
        return self._gather(torch.stack(vals)).tolist()

    def gather_rows(self, xs, device):
        from ..obs import trace as TR
        t0 = TR.TRACER.now() if TR.ENABLED else 0
        out = self._gather(torch.cat(xs)).to(device)
        if TR.ENABLED:
            TR.TRACER.complete("dist.allgather", t0,
                               args={"bytes": out.numel()
                                     * out.element_size()})
        return out

    def all_to_all(self, bufs):
        import torch.distributed as tdist
        L, W = self.local, self.world
        x = torch.stack(bufs)                 # [L_src, S, ...]
        rest = tuple(x.shape[2:])
        # [W, L_src, L_dst, ...]: chunk q of dim 0 goes to process q
        x = x.view((L, W, L) + rest).transpose(0, 1)
        w = self._wire(x)
        out = torch.empty_like(w)
        tdist.all_to_all_single(out, w)
        out = self._unwire(out, x.dtype, self.device)
        return [out[:, :, j].reshape((W * L,) + rest) for j in range(L)]


def init(coordinator: str, num_processes: int, process_id: int,
         local_shards: int = 1, backend: str = None, device=None):
    """Join the process group (idempotent). `coordinator` is
    ``host:port`` of process 0; every process blocks here until all
    have joined. `local_shards` is each process's share of the mesh,
    all on `device` (``cuda`` unless named: ``cuda:(rank % cards)``)."""
    global _STATE
    if _STATE is not None:
        return
    import torch.distributed as tdist
    from ..core.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    tdist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    _STATE = {"rank": process_id, "world": num_processes,
              "local": int(local_shards), "backend": backend,
              "device": dev}


def shutdown():
    """Leave the process group."""
    global _STATE
    if _STATE is not None:
        import torch.distributed as tdist
        tdist.destroy_process_group()
        _STATE = None


def global_mesh():
    """The mesh over every process's shards, this process's part of it:
    its `local_shards` on the device named at :func:`init`."""
    from .shard import Mesh
    if _STATE is None:
        raise RuntimeError("parallel.dist.init() first")
    rank, world, local = _STATE["rank"], _STATE["world"], _STATE["local"]
    dev = _STATE["device"]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    comm = Distributed(rank, world, local, dev, _STATE["backend"])
    return Mesh([dev] * local, size=world * local, first=rank * local,
                comm=comm)


def is_multiprocess() -> bool:
    return _STATE is not None and _STATE["world"] > 1


def rank() -> int:
    return _STATE["rank"] if _STATE is not None else 0


def gather_stats(mesh, shards) -> np.ndarray:
    """The rows of every shard of the mesh (this process holds
    `shards`, one tensor per local shard), in global order, on every
    process: the end-of-run counterpart of the reference's slave ->
    master result handoff. On a multi-process mesh the all-gather is
    this backend's barrier and records a ``dist.allgather`` span when
    tracing is on."""
    return mesh.comm.gather_rows(list(shards), "cpu").numpy()
