"""The no-host-read guard of ``test_torch_graph.py`` on the batched and
the sharded window chunk, on the CPU.

Each chunk runs on the ``meta`` device under ``core.flow.TraceFlow``
(every body once, as a CUDA graph capture records it) and under the
guard, which raises on any read of a tensor's value on the host: the
batched chunk (``engine.window.run_chunk_lanes``) of two lossy phold or
gossip lanes, and the sharded chunk
(``parallel.shard.run_chunk_sharded``) of lossy phold on three stacked
shards with a padding row and one-slot exchange buckets. This shows on
the CPU that both can be captured. Their results against the JAX
package are held in ``test_torch_serving.py`` and
``test_torch_parallel.py``, and on the card in ``test_torch_cuda.py``.
"""

import pytest
import torch

from shadow_tpu_torch.core import flow as FL
from shadow_tpu_torch.core import kernels as K
from shadow_tpu_torch.engine import window as WN
from shadow_tpu_torch.engine.sim import Simulation
from shadow_tpu_torch.engine.state import EngineConfig

from test_torch_graph import SHAPES, NoHostRead, _meta
from test_torch_parity import one_torch_thread  # noqa: F401


def _trace_lanes(shape):
    """Two lanes of `shape` (seeds 1 and 2), their batched chunk traced
    on the meta device under the guard -> the flow's body count."""
    from shadow_tpu_torch.engine.state import stack_rows, stack_shared
    make, cfg = SHAPES[shape]
    sims = []
    for seed in (1, 2):
        scen = make()
        scen.seed = seed
        sims.append(Simulation(scen, engine_cfg=EngineConfig(**cfg),
                               device="cpu"))
    st = stack_rows([s.hosts for s in sims])
    hp = stack_rows([s.hp for s in sims])
    sh = stack_shared([s.sh for s in sims], cfg["num_hosts"])
    plan = WN.make_plan(sims[0].cfg, hp, sh)
    st, hp, sh = _meta(st), _meta(hp), _meta(sh)
    buf = WN.lane_scalars([0, 0], [10**7] * 2, [4 * 10**9] * 2,
                          [10**7] * 2, 8).to("meta")
    WN.prepare_capture(buf.device, sims[0].cfg)
    flow = FL.TraceFlow()
    with torch.inference_mode(), FL.using(flow), NoHostRead():
        WN.run_chunk_lanes(st, hp, sh, sims[0].cfg, plan, buf,
                           torch.zeros_like(st.eq_next))
    return flow._n


def _trace_mesh(shape):
    """`shape` on three stacked shards (a padding row, one-slot exchange
    buckets), the sharded chunk traced on the meta device under the
    guard -> the flow's body count."""
    from shadow_tpu_torch.parallel import shard as SH
    make, cfg = SHAPES[shape]
    sim = Simulation(make(), engine_cfg=EngineConfig(**dict(cfg, a2acap=1)),
                     device="cpu")
    hosts, hp, sh, pcfg = sim._pad_for_mesh(3, sim.hosts, sim.hp, sim.sh)
    plan = SH.sharded_plan(SH.device_put_sharded(
        hosts, hp, sh, pcfg, SH.make_mesh(3, "cpu"), stacked=True))
    ss = SH.device_put_sharded(_meta(hosts), _meta(hp), _meta(sh), pcfg,
                               SH.make_mesh(3, "meta"), stacked=True)
    buf = torch.zeros(K.W_LEN + 3, dtype=torch.int64, device="meta")
    WN.prepare_capture(buf.device, pcfg)
    flow = FL.TraceFlow()
    with torch.inference_mode(), FL.using(flow), NoHostRead():
        SH.run_chunk_sharded(ss, buf[:K.W_LEN], buf[K.W_LEN:], plan)
    return flow._n


@pytest.mark.parametrize("trace,shape", [(_trace_lanes, "phold"),
                                         (_trace_lanes, "gossip"),
                                         (_trace_mesh, "phold")],
                         ids=["lanes-phold", "lanes-gossip", "mesh-phold"])
def test_batched_and_sharded_chunks_read_no_host(trace, shape):
    """The chunk traced under the guard reads nothing on the host, and
    the trace records its bodies (the windows' and the drain's loops,
    the exchange's condition)."""
    assert trace(shape) > 3
