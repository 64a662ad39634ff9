"""Worker process for tests/test_torch_dist.py: one rank of a
two-process mesh of the PyTorch port over gloo on loopback.

    python torch_dist_worker.py <coordinator> <num_procs> <proc_id>
        <out.npy> [--ckpt PATH [--resume]] [--digest PATH] [--pcap DIR]
        [--crash-ns N] [--refusals]

Each process holds 2 shards on the CPU of one 4-shard mesh and runs
:func:`port_scenario`, the port's twin of ``scenario_phold`` (the
reference's multi-process test shape). Rank 0 writes the stats to <out.npy> and every file;
--ckpt checkpoints every simulated second (or, with --resume, resumes
from the store); --digest records a chain every 8 windows; --pcap
writes the pcap files; --crash-ns arms the durability CrashHook, so
every process SIGKILLs itself at the first chunk boundary at or after
that simulated time (after the boundary's snapshot); --refusals then
tries a faulted scenario on the mesh and prints its refusal.
"""

import os
import sys


def main():
    coord, nproc, pid, out = sys.argv[1:5]
    rest = sys.argv[5:]

    def opt(name):
        return rest[rest.index(name) + 1] if name in rest else None

    if opt("--crash-ns"):
        os.environ["SHADOW_TPU_CRASH_SIM_NS"] = opt("--crash-ns")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "..", ".."))
    sys.path.insert(0, here)
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from shadow_tpu_torch.engine.sim import Simulation
    from shadow_tpu_torch.parallel import dist

    dist.init(coord, int(nproc), int(pid), local_shards=2, device="cpu")
    mesh = dist.global_mesh()
    assert mesh.size == 2 * int(nproc) and len(mesh) == 2
    assert dist.is_multiprocess() and dist.rank() == int(pid)
    kw = {}
    ckpt = opt("--ckpt")
    if ckpt and "--resume" in rest:
        kw["resume_from"] = ckpt
    elif ckpt:
        kw.update(checkpoint_path=ckpt, checkpoint_every_s=1.0)
    if opt("--digest"):
        kw.update(digest=opt("--digest"), digest_every=8)
    if opt("--pcap"):
        kw["pcap_dir"] = opt("--pcap")
    r = Simulation(port_scenario(pcap=bool(opt("--pcap"))),
                   engine_cfg=port_cfg(), device="cpu").run(mesh=mesh, **kw)
    # every process holds the whole report; its own shards' rows,
    # gathered, give it back
    hl = r.stats.shape[0] // mesh.size
    mine = [torch.from_numpy(r.stats[(mesh.first + k) * hl:
                                     (mesh.first + k + 1) * hl])
            for k in range(len(mesh))]
    assert (dist.gather_stats(mesh, mine) == r.stats).all()
    if dist.rank() == 0:
        np.save(out, r.stats)
    print(f"proc {pid}: {r.events} events, {r.shards} shards, "
          f"passes {r.shard_passes}, backend {r.mesh['backend']}",
          flush=True)
    if "--refusals" in rest:
        from shadow_tpu_torch.core.config import FaultSpec
        scen = port_scenario()
        scen.faults = [FaultSpec(kind="host_down", at=2 * 10**9,
                                 host="node1")]
        try:
            Simulation(scen, engine_cfg=port_cfg(), device="cpu").run(
                mesh=mesh)
        except NotImplementedError as e:
            print(f"refused: {e}", flush=True)
    dist.shutdown()


def port_scenario(pcap=False):
    """scenario_phold.make_scenario, built with the port's classes."""
    from scenario_phold import N_HOSTS, TOPO
    from shadow_tpu_torch.core.config import HostSpec, ProcessSpec, Scenario
    return Scenario(
        stop_time=3 * 10**9, topology_graphml=TOPO,
        hosts=[HostSpec(id="node", quantity=N_HOSTS, pcap=pcap, processes=[
            ProcessSpec(plugin="phold", start_time=10**9,
                        arguments="port=9000 mean=200ms size=64 init=1")])])


def port_cfg():
    """scenario_phold.make_cfg, the port's EngineConfig."""
    from scenario_phold import N_HOSTS
    from shadow_tpu_torch.engine.state import EngineConfig
    return EngineConfig(num_hosts=N_HOSTS, qcap=16, scap=4, obcap=8,
                        incap=16, chunk_windows=8, app_kinds=(0, 3),
                        uses_tcp=False)


if __name__ == "__main__":
    main()
