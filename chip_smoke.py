"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives ``shadow_tpu_torch`` through its API and CLI on the card and
checks each phase; any failed check raises and the script exits
non-zero. Every modeled run on the card takes the graph path — one
captured CUDA graph replayed a chunk, one host read a chunk — whether
single-device, a batch of lanes or a mesh whose shards share the card
in one process, and the script fails a run that does not
(``check_graph_runs``, in every process; ``batch_of`` for batches).
Phases:

1. device   — the card (nvidia-smi name and power limit), torch/CUDA.
30. flow-kernels — first, as it builds the kernel library
              (``csrc/flow.cu`` through nvcc into build/kernels, or loads
              it): the pass-flags and advance kernels bit-equal to their
              plain versions on the card at 1 to 100,003 rows
              (CHECK_ROWS), and advance_lanes at 1, 2, 4 and 7 lanes of
              1 to 25,001 rows (LANE_CHECK, the timed 4,096 and 25,000
              among them), contiguous and on views one element into a
              larger tensor, and each across 56-64 executions in one
              captured graph, each with its own inputs and outputs,
              replayed twice; at 4,096, 10,000 and 100,000
              rows (advance_lanes at 4 x 4,096 and 4 x 25,000) their
              times (CUDA events) launched eagerly (``ms``) and as 200
              launches captured in one graph (``graph_ms``), beside an
              empty kernel's in a graph (``floor_ms``; ``floor_body_ms``
              inside a conditional node's body, as the chunk captures
              it), the plain versions' and the bounds. The timed graphs
              replay the same inputs, which stay in L2 as the chunk's
              rows do (the drain has just written them); the bounds are
              HBM's.

The timed phases run first, each alone on the card and the host:

2. ping     — examples/ping.xml through the CLI: mean RTT exactly 50 ms.
3. phold    — phold-4096, 5 sim-s (bench.py's shape): messages conserved;
              the main path of the kernels line, whose launches (captured)
              and executions on the card it counts (4. and 5. count their
              executions too: the kernels line's ``cells``).
4. gossip   — examples/gossip-100k.xml, 100,000 hosts, 30 sim-s, with the
              caps from its own comment: >= 99.9% of hosts saw every
              mined block.
18. gossip-100k-telemetry — right after 4: the same XML and caps through
              ``python -m shadow_tpu_torch`` with ``--netscope --metrics
              --trace --perf LEDGER --heartbeat-frequency 10`` (files in a
              temporary directory): phase 4's stats, an RTT histogram
              holding every ST_RTT_COUNT sample, one [node] line per host
              in each heartbeat emission (the tracker folds the
              boundaries one chunk crosses into one emission), sim and
              net sections in metrics.json, >= 90% of the wall attributed
              or the residual named, a ``cuda`` ledger entry; the wall
              printed beside phase 4's.
22. passcope — phold-4096 to 2 sim-s (one sim-s of traffic after its
              1 s start) in 16-window chunks, once plain and once with
              ``run(passcope=DIR)`` tracing the first chunk: equal stats,
              windows and passes, and >= 90% of the card's kernel time
              attributed to pass labels; prints the label table (kernel
              ms, host issue ms and sync ms per label, and runtime_ms,
              the host's waits for the card).
24. batch-phold-4096x4 — four lanes of phold-4096 (bench.py's shape,
              16,384 rows), seeds 1-4, 5 sim-s, through
              ``serving.batch.run_batch`` on the graph path (the batched
              chunk, one captured graph a chunk, one host read a chunk):
              each lane's digest chain, stats, windows and passes equal
              its seed's run alone on the card; prints the batch wall,
              the summed events/s, the stacked passes, the graph path's
              figures and the four walls alone. The main path of
              advance_lanes' launches, which it counts.
5. socks10k — 10,000 hosts (1,000 bulkservers, 1,000 socksproxies,
              8,000 socksclients fetching 48 KiB through one relay) on
              the ER-300 stand-in topology, runahead 10 ms, through
              Simulation: clients complete fetches, no host's socket
              table overflows; then three replays of one of its chunks
              (``ChunkSpan``): host wall, device span, ms a pass.
6. tgen-1k  — 1,000 tgen hosts (200 servers, 600 web clients fetching
              100 KiB, 200 bulk clients putting 1 MiB; ``bench.py``'s
              tgen-1k-tcp shape) on the ER-300 stand-in, runahead 10 ms,
              through Simulation: GETs and PUTs complete, no walk branch
              is lost, no socket table or event queue overflows; then
              three replays of one of its chunks.
23. census  — no run of its own (after 5.): socks10k's
              ``SimReport.memory`` census (state bytes, per host, hot)
              beside the allocator's peak
              (``torch.cuda.max_memory_allocated``), which must hold the
              state.
Then the checks that time nothing run, beside phases 7, 13, 17, 20 and
26-27, each in a process of its own on the same card (‡ in PERF.md:
their walls are taken beside the other processes):

7. cli-tgen — examples/tgen-web-bulk.xml through ``python -m
              shadow_tpu_torch`` on the card: every web host completes
              its 10 GETs and every bulk host its 5.
8. log1p    — log1p_f32 over all 2^24 uniforms: cuda bits == cpu bits.
9. gpu=cpu  — lossy phold-256 and gossip-1000 on cuda and on cpu: equal
              stats and equal Hosts fields.
10. cbrt    — the congestion control's float32 cbrt over 2^24 inputs
              spread over every binade from 2^-20 to 2^20, plus 0 and
              the special values: cuda bits == cpu bits.
11. tcp-gpu=cpu — lossy bulk and multihop lossy SOCKS on cuda and on
              cpu: equal stats and equal Hosts fields.
12. cli-tcp — the same bulk and SOCKS scenarios as XML through
              ``python -m shadow_tpu_torch --runahead 10ms`` on the card.
13. tgen-gpu=cpu — tgen shapes (lossy web walk, fork/synchronize, a
              host running a tgen server beside a bulk client, tgen-1k
              at 50 hosts) on cuda and on cpu: equal stats, windows and
              Hosts fields.
14. faults-demo — examples/faults-demo.xml through ``python -m
              shadow_tpu_torch --digest`` on the card and with ``--device
              cpu``: equal digest chains; the pings in [4 s, 6 s) are
              lost on the dead link, the 7 s ping at the dead server, and
              the pings from 8 s on are answered.
15. ckpt-gpu=cpu — the multihop lossy SOCKS shape of phase 11 with one
              relay's host_down episode, checkpointed on the card and
              resumed on the CPU from a snapshot inside the episode: its
              digest chain equals an uninterrupted CPU run's (and the
              card's).
16. cpu-model-gpu=cpu — tests/test_cpu_model.py's blocked-threshold
              shape on cuda and on cpu: equal stats and digest chains.
19. telemetry-gpu=cpu — phase 11's lossy bulk and 2-hop lossy SOCKS with
              netscope on and logpcap on two hosts, on cuda and on cpu
              (the CPU halves in a child process): equal stats, Hosts
              fields, netscope JSONL bytes, pcap bytes and heartbeat
              lines (apart from dev=, waste= and the getrusage columns).
25. fleet    — ``python -m shadow_tpu_torch fleet run --workers 2`` on
              the card over two port runs of an 8-host phold and a
              two-member batch group of it (``fleet submit --batch
              --seeds 1,2``): the queue drains with no crash and every
              digest chain equals its run alone on the card. Run in a
              process of its own beside these checks.
21. hosted-gpu=cpu — tests/test_torch_hosting.py's shapes (a hosted UDP
              pinger and TCP putter, hosted beside modeled on one host,
              the loopback self-channel, a pipe, the cping C plugin) on
              cuda and on cpu: equal stats, windows, Hosts fields (the
              wake rings included) and what the apps saw.
26. mesh-phold-4096x4 — phold-4096 on a four-shard mesh on the card
              (``parallel.shard.make_mesh(4)``, every shard on cuda:0, so
              the shards are row views of one stacked state and the
              sharded chunk runs as one captured graph a chunk),
              prewarmed (``Simulation.prewarm(mesh=...)`` captures it;
              the run replays it, capturing nothing): the stats, windows
              and digest chain (every 64 windows) of an untimed single
              run of phase 3's shape, whose stats and windows equal phase
              3's; prints the wall, the graph path's figures, the
              kernels' launches, the passes and events per shard and
              their imbalance. Then
27. mesh-gossip-100k — examples/gossip-100k.xml as written, 100,000 hosts
              on four shards: phase 4's stats and windows; the same
              figures, and the wall of phase 4's run again right after
              in this process (``single_here_wall_s``, beside the same
              other processes). 26 and 27 run in one process of their
              own, started with 7's (‡ in PERF.md: their walls are
              taken beside the other processes).
28. mesh-tcp-gpu=cpu — phase 11's lossy 2-hop SOCKS shape to 30 sim-s on
              four shards with two-slot exchange buckets (``a2acap=2``):
              bursts defer into ST_DEFER_A2A (> 0), and the card's mesh
              on the graph path gives its eager path's
              (``graph=False``) and the CPU mesh's stats, windows,
              passes a shard and digest chain (the CPU half in a process
              of its own, started with 7's).
29. dist-phold — phold-4096 on two processes of two shards each, through
              ``parallel.dist`` on the card (gloo with fewer than two
              cards, as NCCL refuses two ranks on one; nccl otherwise;
              the backend printed): phase 3's stats and windows, 26's
              single chain, and the bytes the gloo collectives staged
              through host memory; the ranks start after 21., beside 28.
17. socks10k-faults — socks10k's 10,000 hosts to 3 sim-s under a fault
              schedule (relay1-50 down over [2.3 s, 2.7 s), 5% loss
              between relay51 and server1 over [2.2 s, 2.8 s), +5 ms
              between client1 and relay52 over [2.4 s, 2.9 s)): run A
              records a digest chain every 16 windows and checkpoints
              every 0.75 sim-s, keeping 2; run B, a fresh Simulation,
              resumes from the snapshot taken inside the host_down and
              loss episodes (by its fault schedule position) and must
              end with run A's chain, final stats and fault log.

20. hosted-shim-64 — 64 unmodified binaries, each behind its own
              LD_PRELOAD shim, through Simulation on the two-vertex
              topology: srv1..srv8 run examples/plugins/epserver (28
              serves each), cli1..cli56 epclient (4 uploads of 100 KiB to
              srv<1 + i mod 8>, starting at 2 s + i x 10 ms), 60 sim-s:
              every output reads its transfers, 64 exits with status 0,
              the servers received 56 x 409,600 bytes, no capacity
              overflow; it prints its events, windows, passes, wall,
              events/s and the share of the wall spent in
              ``hosting.step`` (the CPU tier between windows). It takes
              ~230 s alone on the card, so it runs beside the untimed
              checks; its CPU twin runs in another process and must give
              equal stats, windows, Hosts fields, digest records (their
              state sections), op-stream digest and child outputs
              (checked last).

31. graph=eager — phold-4096 (5 sim-s) and phase 11's 2-hop lossy SOCKS
              shape, each on the card on the graph path and with
              ``run(graph=False)`` on the eager path: equal stats, windows,
              digest chains and Hosts fields; a run after
              ``Simulation.prewarm`` replays the prewarmed graph with the
              same stats and chain; prints the captures, the
              capture wall, replays, host reads a chunk, the graph's pool
              bytes and conditional nodes, and both walls. Then two
              batches on both paths (``run_batch(graph=False)``): four
              phold-1024 lanes (seeds 1-4, 5 sim-s) and two lanes of the
              2-hop lossy SOCKS shape to 30 sim-s (TCP lanes through
              ``exchange_lanes``): each lane's chain, stats, windows and
              passes equal.
32. aot-cache — two children on examples/ping.xml: ``--prewarm --aot-cache
              DIR`` captures the chunk, then a run with ``--aot-cache DIR``
              builds no library and loads it from DIR (a disk hit).

``--phases tgen-1k-cpu`` (never part of the default run) holds tgen-1k
itself, all 1,000 hosts to 2.25 sim-s, on cuda against cpu: equal
stats, windows and Hosts fields. ``--phases paths-alone`` (never part
of the default run either) times batch-phold-4096x4, mesh-phold-4096x4
and mesh-gossip-100k on both paths, alone in this process: the graph
path, then ``graph=False``; equal stats, windows and passes.

``python3 chip_smoke.py --profile`` instead measures where the wall
goes in phold-4096 and gossip-100k: a per-phase wall split (drain,
exchange, advance; synchronized at each phase end) and a
``torch.profiler`` run (kernel launches, device kernel time, the
device's busy share against the unprofiled wall, the top kernels).
``--phases a,b`` runs only the named phases of the default run (or of
``--profile``).

The binaries, the shim library and the C plugin build with cc into
the port's build directory (``shadow_tpu_torch/hosting/build.py``) at
first use; a failed build fails the run.

The JAX package has no Pallas kernel. The port's hand-written kernels
are the chunk's reductions (``csrc/flow.cu``: pass flags, advance and
advance_lanes); the ``kernels`` line lists them with phase 30's
figures, the launches of each on its main path (phase 3's run;
advance_lanes: phase 24's batch), the launches counted on each path
(phases 3, 24 and 26, each with the counts set to 0 just before it)
and the executions a pass and a window of phases 3, 4, 5 and 24. The last line is the contract line
``{"ok": true, "device": {...}}``. With no CUDA device the script exits
non-zero before printing any result.
"""

import contextlib
import ctypes
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# the script's start, shared with its child processes
T0_ENV = "CHIP_SMOKE_T0"


def phase(name, wall, **kv):
    """One passed phase's line; `at` is the script's wall when it ended."""
    extra = " ".join(f"{k}={v}" for k, v in kv.items())
    at = time.time() - float(os.environ[T0_ENV])
    print(f"phase {name}: ok wall={wall:.3f}s at={at:.1f}s {extra}".rstrip(),
          flush=True)


def phold_scenario(n, stop_s, loss=0.0, bw_kib=102400, mean="500ms"):
    from shadow_tpu_torch.core.config import HostSpec, ProcessSpec, Scenario
    topo = f"""
<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="d7"/>
  <key attr.name="packetloss" attr.type="double" for="edge" id="d9"/>
  <key attr.name="packetloss" attr.type="double" for="node" id="d0"/>
  <key attr.name="bandwidthup" attr.type="int" for="node" id="d4"/>
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="d3"/>
  <graph edgedefault="undirected">
    <node id="poi"><data key="d0">0.0</data>
      <data key="d3">{bw_kib}</data><data key="d4">{bw_kib}</data></node>
    <edge source="poi" target="poi"><data key="d7">25.0</data>
      <data key="d9">{loss}</data></edge>
  </graph>
</graphml>
"""
    return Scenario(
        stop_time=stop_s * 10**9, topology_graphml=topo,
        hosts=[HostSpec(id="node", quantity=n, processes=[
            ProcessSpec(plugin="phold", start_time=10**9,
                        arguments=f"port=9000 mean={mean} size=64 "
                                  "init=1")])])


def phold_cfg(n):
    from shadow_tpu_torch.engine.state import EngineConfig
    return EngineConfig(num_hosts=n, qcap=16, scap=4, obcap=8, incap=16,
                        chunk_windows=512)


def gossip_cfg(n):
    from shadow_tpu_torch.engine.state import EngineConfig
    return EngineConfig(num_hosts=n, qcap=16, scap=2, obcap=16, incap=32,
                        chunk_windows=256)


def gossip_scenario(n_hosts, stop_s=None):
    from shadow_tpu_torch.core.config import load_xml
    scen = load_xml(os.path.join(HERE, "examples", "gossip-100k.xml"))
    if n_hosts != scen.total_hosts():
        scen.hosts[1].quantity = n_hosts - 1
        for h in scen.hosts:
            for p in h.processes:
                p.arguments += f" n={n_hosts}"
    if stop_s is not None:
        scen.stop_time = stop_s * 10**9
    return scen


def run(scen, cfg, device, **kw):
    from shadow_tpu_torch.engine.sim import Simulation
    sim = Simulation(scen, engine_cfg=cfg, device=device)
    rep = sim.run(**kw)
    return sim, rep


def check_graph_runs():
    """Every run on the card that its configuration sends down the graph
    path (a single-device modeled run with no per-phase clock, passcope
    or graph=False) must report path graph, one host read a chunk and a
    replay a chunk: wraps ``Simulation.run`` in this process."""
    from shadow_tpu_torch.engine.sim import Simulation
    inner = Simulation.run
    if getattr(inner, "checked", False):
        return

    def checked(self, *a, **kw):
        rep = inner(self, *a, **kw)
        ex = rep.execution
        want = self.execution_path(kw.get("mesh"), False, kw.get("clock"),
                                   kw.get("graph", True))[0]
        if ex["path"] == "eager" and ex["reason"].startswith("passcope"):
            want = "eager"
        if ex["path"] != want:
            fail(f"a run on {self.device} took the {ex['path']} path "
                 f"({ex['reason']}), its configuration the {want} path")
        if ex["path"] == "graph" and not (
                ex["host_reads_per_chunk"] == 1.0
                and ex["replays"] == ex["chunks"]):
            fail(f"a graph run read the host {ex['host_reads_per_chunk']} "
                 f"times a chunk, replayed {ex['replays']} graphs for "
                 f"{ex['chunks']} chunks")
        return rep
    checked.checked = True
    Simulation.run = checked


def graph_of(rep, name):
    """The graph path's figures of a card run, which must have taken
    it, as phase-line fields."""
    ex = rep.execution
    if ex.get("path") != "graph":
        fail(f"{name}: the card's run took the {ex.get('path')} path "
             f"({ex.get('reason')})")
    return {"path": "graph", "captures": ex["captures"],
            "capture_wall_s": round(ex["capture_wall_s"], 3),
            "replays": ex["replays"],
            "host_reads_per_chunk": ex["host_reads_per_chunk"],
            "pool_bytes": ex["pool_bytes"]}


def graph_str(rep, name):
    g = graph_of(rep, name)
    return " ".join(f"{k}={v}" for k, v in g.items())


def graph_summary(s, name):
    """The same check on a card run's summary dict -> its fields."""
    if (s.get("path"), s.get("host_reads_per_chunk")) != ("graph", 1.0):
        fail(f"{name}: the card's run took the {s.get('path')} path "
             f"({s.get('path_reason')}), {s.get('host_reads_per_chunk')} "
             "host reads a chunk")
    return (f"path=graph captures={s['captures']} replays={s['replays']} "
            f"host_reads_per_chunk=1.0")


def rates(rep):
    return rates_of(rep.summary())


def rates_of(s):
    """A run's summary -> the figures every timed phase prints."""
    return dict(events=s["events"], windows=s["windows"],
                passes=s["passes"], wall_s=round(s["wall_seconds"], 3),
                events_per_s=round(s["events_per_sec"], 1),
                sim_s_per_wall_s=round(s["speedup"], 4))


def profile_cell(name, mk, cfg):
    """Wall split by phase, then a torch.profiler run of the same cell
    (the same passes: the run is deterministic)."""
    from torch.profiler import ProfilerActivity, profile

    split = {"drain": 0.0, "exchange": 0.0, "advance": 0.0}
    last = [0.0]

    def clock(label):
        torch.cuda.synchronize()
        now = time.perf_counter()
        split[label] += now - last[0]
        last[0] = now

    from shadow_tpu_torch.engine.sim import Simulation
    sim = Simulation(mk(), engine_cfg=cfg, device="cuda")
    last[0] = time.perf_counter()
    rep = sim.run(clock=clock)
    plain_wall = rep.wall_seconds
    print(f"profile {name}: split " + json.dumps(
        {k: round(v, 4) for k, v in split.items()}
        | {"wall_s": round(rep.wall_seconds, 4), "passes": rep.passes,
           "windows": rep.windows}), flush=True)

    sim = Simulation(mk(), engine_cfg=cfg, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rep = sim.run()
    kern_us, launches, by_name = 0.0, 0, {}
    for e in prof.key_averages():
        if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            launches += e.count
        dev = getattr(e, "self_device_time_total", 0.0)
        if dev and str(getattr(e, "device_type", "")).endswith("CUDA"):
            kern_us += dev
            by_name[e.key] = by_name.get(e.key, 0.0) + dev
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile {name}: " + json.dumps({
        "wall_s": round(rep.wall_seconds, 4), "passes": rep.passes,
        "kernel_launches": launches,
        "launches_per_pass": round(launches / max(rep.passes, 1), 1),
        "device_kernel_ms": round(kern_us / 1e3, 3),
        # against the unprofiled run's wall: the profiler slows the host
        "device_busy_share": (round(kern_us / 1e6 / plain_wall, 4)
                              if kern_us else "not measured"),
        "top_kernels_ms": {k[:60]: round(v / 1e3, 3) for k, v in top}}),
        flush=True)

# socks10k stop time (sim-s; clients start at 2 s): the full 10 sim-s
# took 458.6 s of drain on the card, so the script runs the 5 sim-s floor
SOCKS_STOP_S = 5
# passcope: phold-4096 to 2 sim-s (one sim-s of traffic after its 1 s
# start, 40 windows), tracing its first chunk of 16 windows: the
# profiler multiplies the wall of what it traces (PERF.md §6)
PASSCOPE_STOP_S = 2
PASSCOPE_WINDOWS = 16
BATCH_STOP_S = 5


def poi_topology(loss=0.0, bw_down=20480, bw_up=10240, latency_ms=20.0):
    """One vertex with a lossy self-loop (tests/test_tcp.py's shape)."""
    return f"""
<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="d7"/>
  <key attr.name="packetloss" attr.type="double" for="edge" id="d9"/>
  <key attr.name="packetloss" attr.type="double" for="node" id="d0"/>
  <key attr.name="bandwidthup" attr.type="int" for="node" id="d4"/>
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="d3"/>
  <graph edgedefault="undirected">
    <node id="poi"><data key="d0">0.0</data>
      <data key="d3">{bw_down}</data><data key="d4">{bw_up}</data></node>
    <edge source="poi" target="poi"><data key="d7">{latency_ms}</data>
      <data key="d9">{loss}</data></edge>
  </graph>
</graphml>
"""


def bulk_scenario(loss, size, count, stop=60):
    """tests/test_differential.py:_bulk_scen: one bulkserver, one bulk
    client."""
    from shadow_tpu_torch.core.config import HostSpec, ProcessSpec, Scenario
    return Scenario(
        stop_time=stop * 10**9, topology_graphml=poi_topology(loss=loss),
        hosts=[
            HostSpec(id="server", processes=[
                ProcessSpec(plugin="bulkserver", start_time=10**9,
                            arguments="port=80")]),
            HostSpec(id="client", processes=[
                ProcessSpec(plugin="bulk", start_time=2 * 10**9,
                            arguments=f"peer=server port=80 size={size} "
                                      f"count={count} pause=1s")])])


def socks_scenario(loss, hops, stop, clients=3):
    """tests/test_differential.py:_socks_scen: 2 servers, 3 relays and
    `clients` socks clients."""
    from shadow_tpu_torch.core.config import HostSpec, ProcessSpec, Scenario
    return Scenario(
        stop_time=stop * 10**9, topology_graphml=poi_topology(loss=loss),
        hosts=[
            HostSpec(id="server", quantity=2, processes=[
                ProcessSpec(plugin="bulkserver", start_time=10**9,
                            arguments="port=80")]),
            HostSpec(id="relay", quantity=3, processes=[
                ProcessSpec(plugin="socksproxy", start_time=10**9,
                            arguments="port=9050 server-port=80 "
                                      "relay-lo=2 relay-hi=5")]),
            HostSpec(id="client", quantity=clients, processes=[
                ProcessSpec(plugin="socksclient", start_time=2 * 10**9,
                            arguments=f"proxy-lo=2 proxy-hi=5 "
                                      f"proxy-port=9050 server-lo=0 "
                                      f"server-hi=2 size=30000 count=2 "
                                      f"pause=1s hops={hops}")])])


def cbrt_inputs():
    """2^24 float32 inputs spread evenly over the 40 binades from 2^-20
    to 2^20, then 0, -0, 1, the binade edges, inf, -inf and NaN."""
    n = 1 << 24
    per = n // 40
    k = torch.arange(40 * per, dtype=torch.int64)
    frac = (k % per).to(torch.float64) / per
    x = torch.ldexp(1.0 + frac, (k // per - 20).to(torch.float64))
    edges = [0.0, -0.0, 1.0, 2.0**-20, 2.0**20, float("inf"),
             float("-inf"), float("nan")]
    return torch.cat([x.to(torch.float32),
                      torch.tensor(edges, dtype=torch.float32)])


class ChunkSpan:
    """Host wall and device span of one captured chunk of a graph-path
    run: the first chunk that starts at or after `at_ns` of simulated
    time. The run copies its state where that chunk starts and goes on;
    after the run, ``report`` copies it back into the run's own tensors
    (the chunk's graph reads those) and replays that chunk three times,
    each timed by the host clock and by CUDA events around it. The
    device span is the card's time from the graph's first node to its
    last; over the host wall it says how far the host still holds the
    card back. (``torch.profiler`` sees only a graph's top-level nodes,
    not the kernels inside its conditional bodies, so it cannot split
    the span into kernel time and gaps.) ``report`` overwrites the
    run's final state."""

    def __init__(self, at_ns):
        self.at = at_ns
        self.snap = None
        self.cost = 0.0

    @contextlib.contextmanager
    def attached(self):
        from shadow_tpu_torch.engine import sim as S
        inner = self.inner = S.run_windows_graph
        S.run_windows_graph = self._chunk
        try:
            yield self
        finally:
            S.run_windows_graph = inner

    def _chunk(self, st, hp, sh, ws, we, cfg, max_windows, plan,
               stop=None):
        if self.snap is None and ws >= self.at:
            t0 = time.perf_counter()
            self.snap = {k: v.clone() for k, v in vars(st).items()}
            self.args = (st, hp, sh, ws, we, cfg, max_windows, plan)
            self.stop = stop
            torch.cuda.synchronize()
            self.cost += time.perf_counter() - t0
        return self.inner(st, hp, sh, ws, we, cfg, max_windows, plan,
                          stop=stop)

    def _replay(self):
        """Replay the chunk from the copy -> (windows, passes, host wall
        ms, device span ms)."""
        st = self.args[0]
        for k, v in self.snap.items():
            getattr(st, k).copy_(v)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        _, _, n, passes = self.inner(*self.args, stop=self.stop)
        b.record()
        torch.cuda.synchronize()
        return n, passes, (time.perf_counter() - t0) * 1e3, a.elapsed_time(b)

    def report(self):
        if self.snap is None:
            fail(f"no chunk started at or after {self.at} ns")
        runs = [self._replay() for _ in range(3)]
        self.snap = None
        if len({r[:2] for r in runs}) != 1 or not runs[0][1]:
            fail(f"chunk replays ran {[r[1] for r in runs]} passes")
        n, passes = runs[0][:2]
        walls, spans = [r[2] for r in runs], [r[3] for r in runs]
        best = min(range(3), key=lambda i: walls[i])
        return {"sim_ns": self.args[3], "windows": n, "passes": passes,
                "chunk_wall_ms": [round(w, 3) for w in walls],
                "device_span_ms": [round(d, 3) for d in spans],
                "ms_per_pass": round(walls[best] / passes, 4),
                "device_span_share": round(spans[best] / walls[best], 4),
                "state_copy_s": round(self.cost, 3)}


# tgen-1k stop time (sim-s; clients start at 2 s; bench.py runs 10):
# 2.25 sim-s (6,205 passes) took 143.4-170.2 s on the card, 2.5 sim-s
# (11,708 passes) 249.2-394.9 s, 4 sim-s (28,341 passes) 547.0 s; 2.5
# took the whole script to 1,208 s on a slow host once the telemetry
# phases were added
TGEN_STOP_S = 2.25
# the chunks ChunkSpan replays: the first at or after these sim times,
# with every client active
TGEN_SPAN_NS = 2_100_000_000
SOCKS_SPAN_NS = 2_500_000_000


def two_poi_topology(loss=0.0):
    """tests/conftest.py's simple topology: two vertices, 20 ms
    self-loops, a 50 ms link between them; `loss` on every edge."""
    edges = "".join(
        f'<edge source="poi-{a}" target="poi-{b}"><data key="d7">{lat}'
        f'</data><data key="d9">{loss}</data></edge>'
        for a, b, lat in ((1, 1, 20.0), (1, 2, 50.0), (2, 2, 20.0)))
    nodes = "".join(
        f'<node id="poi-{i}"><data key="d0">0.0</data><data key="d3">2048'
        f'</data><data key="d4">1024</data></node>' for i in (1, 2))
    return f"""<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="packetloss" attr.type="double" for="edge" id="d9"/>
  <key attr.name="latency" attr.type="double" for="edge" id="d7"/>
  <key attr.name="bandwidthup" attr.type="int" for="node" id="d4"/>
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="d3"/>
  <key attr.name="packetloss" attr.type="double" for="node" id="d0"/>
  <graph edgedefault="undirected">{nodes}{edges}</graph></graphml>"""


def fork_graph():
    """tests/test_tgen.py's fork client: two parallel GETs joined by
    synchronize, 2 rounds."""
    from shadow_tpu_torch.baseline_configs import _TGEN_KEYS
    return (
        '<graphml xmlns="http://graphml.graphdrawing.org/xmlns">'
        f'{_TGEN_KEYS}<graph edgedefault="directed">'
        '<node id="start"><data key="d0">server1:30080,server2:30080</data>'
        '</node><node id="transfer1"><data key="d4">get</data>'
        '<data key="d5">10 KiB</data></node>'
        '<node id="transfer2"><data key="d4">get</data>'
        '<data key="d5">20 KiB</data></node>'
        '<node id="synchronize"/><node id="end"><data key="d6">4</data></node>'
        '<edge source="start" target="transfer1"/>'
        '<edge source="start" target="transfer2"/>'
        '<edge source="transfer1" target="synchronize"/>'
        '<edge source="transfer2" target="synchronize"/>'
        '<edge source="synchronize" target="end"/>'
        '<edge source="end" target="start"/></graph></graphml>')


SERVER_GRAPH = os.path.join(HERE, "examples", "tgen.server.graphml.xml")


def tgen_scenario(client_graph, n_servers, n_clients, stop, loss=0.0):
    """tgen servers named server1.. and tgen clients walking
    `client_graph` on the two-vertex topology."""
    from shadow_tpu_torch.core.config import HostSpec, ProcessSpec, Scenario
    return Scenario(
        stop_time=stop * 10**9, topology_graphml=two_poi_topology(loss),
        hosts=[
            HostSpec(id="server", quantity=n_servers, processes=[
                ProcessSpec(plugin="tgen", start_time=10**9,
                            arguments=SERVER_GRAPH)]),
            HostSpec(id="client", quantity=n_clients, processes=[
                ProcessSpec(plugin="tgen", start_time=2 * 10**9,
                            arguments=client_graph)])])


def combo_scenario():
    """tests/test_multiproc.py's tgen server + bulk client host."""
    from shadow_tpu_torch.core.config import HostSpec, ProcessSpec, Scenario
    return Scenario(
        stop_time=40 * 10**9, topology_graphml=poi_topology(),
        hosts=[
            HostSpec(id="combo", processes=[
                ProcessSpec(plugin="tgen", start_time=10**9,
                            arguments=SERVER_GRAPH),
                ProcessSpec(plugin="bulk", start_time=2 * 10**9,
                            arguments="peer=peer port=80 size=40000 "
                                      "count=1 pause=1s")]),
            HostSpec(id="peer", processes=[
                ProcessSpec(plugin="bulkserver", start_time=10**9,
                            arguments="port=80")])])


def socks10k_sim():
    """socks10k on the card, stopping at SOCKS_STOP_S sim-s."""
    from shadow_tpu_torch.baseline_configs import socks10k
    return socks10k(n=10_000, stop=SOCKS_STOP_S, device="cuda",
                    runahead_ms=10)



# hosted-shim-64: 8 epserver and 56 epclient binaries behind the shim
SHIM_SERVERS, SHIM_CLIENTS = 8, 56
SHIM_XFERS, SHIM_BYTES = 4, 102_400
# the automatic caps of this topology (engine.sim.auto_engine_config:
# one window of a 2 MiB/s link) with a socket table for a server's 7
# connections: test_shim.py's qcap=32 lets a server's queue fill with
# later arrivals while an earlier one waits in an outbox, which stalls
# the window at that arrival
SHIM_CFG = dict(qcap=256, scap=16, obcap=64, incap=128, txqcap=16,
                hostedcap=32)


def shim_bins():
    """examples/plugins' epserver and epclient, built with cc into the
    port's build directory (hosting.build) -> {name: path}."""
    from shadow_tpu_torch.hosting.build import build_dir, compile_c
    out = {}
    for name in ("epserver", "epclient"):
        src = os.path.join(HERE, "examples", "plugins", name + ".c")
        out[name] = compile_c(["cc", "-O2", src, "-o"],
                              os.path.join(build_dir(), name), src)
    return out


def shim64_scenario(bins, outdir, xfers=SHIM_XFERS):
    """64 real processes on the two-vertex topology: srv1..srv8 each
    serve 7 clients' uploads; cli<i+1> uploads `xfers` x 100 KiB to
    srv<1 + i mod 8>, starting at 2 s + i x 10 ms; each child's stdout
    goes to <outdir>/<host>.out."""
    from shadow_tpu_torch.core.config import HostSpec, ProcessSpec, Scenario

    def shim(host, start_ns, argv):
        return HostSpec(id=host, processes=[ProcessSpec(
            plugin="hosted:shim", start_time=start_ns,
            arguments=f"out={os.path.join(outdir, host + '.out')} "
                      f"cmd={argv}")])

    per_srv = SHIM_CLIENTS // SHIM_SERVERS * xfers
    hosts = [shim(f"srv{k + 1}", 10**9, f"{bins['epserver']} 8080 {per_srv}")
             for k in range(SHIM_SERVERS)]
    hosts += [shim(f"cli{i + 1}", 2 * 10**9 + i * 10**7,
                   f"{bins['epclient']} srv{1 + i % SHIM_SERVERS} 8080 "
                   f"{SHIM_BYTES} {xfers}") for i in range(SHIM_CLIENTS)]
    return Scenario(stop_time=60 * 10**9, topology_graphml=two_poi_topology(),
                    hosts=hosts)


def shim64_run(device, bins, outdir, xfers=SHIM_XFERS, digest=None):
    """hosted-shim-64 on `device` -> (stats, Hosts arrays, summary, exit
    report, the hosting runtime's op-stream digests, the seconds spent in
    hosting.step and in its op replay (`_flush`), {host: child output},
    the capacity report)."""
    from shadow_tpu_torch.engine.sim import Simulation
    from shadow_tpu_torch.engine.state import EngineConfig
    sim = Simulation(shim64_scenario(bins, outdir, xfers),
                     engine_cfg=EngineConfig(num_hosts=64, **SHIM_CFG),
                     device=device)
    step, flush, spent = sim.hosting.step, sim.hosting._flush, [0.0, 0.0]

    def timed(fn, i):
        def call(*a):
            t0 = time.perf_counter()
            fn(*a)
            spent[i] += time.perf_counter() - t0
        return call

    sim.hosting.step = timed(step, 0)
    sim.hosting._flush = timed(flush, 1)
    t0, windows = time.perf_counter(), [0]

    def progress(label):
        if label == "advance":
            windows[0] += 1
            if windows[0] % 500 == 0:
                print(f"  hosted-shim-64 ({device}): {windows[0]} windows, "
                      f"wall {time.perf_counter() - t0:.1f}s", flush=True)

    rep = sim.run(digest=digest, digest_every=64, clock=progress)
    outs = {n: open(os.path.join(outdir, n + ".out")).read()
            for n in rep.host_names}
    return (*arrays(sim, rep), rep.summary(), rep.hosted,
            sim.hosting.digest_state(), spent, outs,
            rep.capacity_report())


def _shim64_gpu_child(conn):
    """A child process: phase 20 on the card -> its result, or the
    failure."""
    from shadow_tpu_torch.engine import defs
    try:
        conn.send((None, shim64_phase(defs)))
    except BaseException as e:
        conn.send((f"{type(e).__name__}: {e}", None))
        raise


def _shim64_cpu_child(conn):
    """A child process: hosted-shim-64's CPU twin -> its shim64_run
    result and the digest chain's bytes, or the failure."""
    import tempfile
    try:
        torch.set_num_threads(1)
        with tempfile.TemporaryDirectory() as d:
            dg = os.path.join(d, "chain.jsonl")
            res = shim64_run("cpu", shim_bins(), d, digest=dg)
            conn.send((None, res, open(dg, "rb").read()))
    except BaseException as e:
        conn.send((f"{type(e).__name__}: {e}", None, None))
        raise


def shim64_phase(defs):
    """20. hosted-shim-64 on the card: 64 real processes behind the
    shim, every upload and serve done, 64 clean exits -> (the run's
    result, its digest chain) for the CPU twin to equal."""
    import tempfile
    bins = shim_bins()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        dg = os.path.join(d, "chain.jsonl")
        res = shim64_run("cuda", bins, d, digest=dg)
        chain = open(dg, "rb").read()
    st, _, s, hosted, digests, (step_s, flush_s), outs, cap = res
    want_cli = f"transfers={SHIM_XFERS} bytes={SHIM_XFERS * SHIM_BYTES}"
    per_srv = SHIM_CLIENTS // SHIM_SERVERS * SHIM_XFERS
    want_srv = f"transfers={per_srv} bytes={per_srv * SHIM_BYTES}"
    short = [n for n, o in outs.items()
             if (want_srv if n.startswith("srv") else want_cli) not in o]
    if short:
        fail(f"hosted-shim-64: hosts short of their transfers: {short} "
             f"(e.g. {outs[short[0]]!r})")
    bad = {n: v for n, v in hosted.items()
           if v.get("exit_status") != 0 or not v.get("clean")}
    if len(hosted) != 64 or bad:
        fail(f"hosted-shim-64: {len(hosted)} exits, not clean: {bad}")
    recv = int(st[:SHIM_SERVERS, defs.ST_BYTES_RECV].sum())
    if recv != SHIM_CLIENTS * SHIM_XFERS * SHIM_BYTES:
        fail(f"hosted-shim-64: servers received {recv} bytes")
    over = [r for r in cap if r["overflow"]]
    if over:
        fail(f"hosted-shim-64: capacity overflow {over}")
    phase("hosted-shim-64", time.perf_counter() - t0,
          **rates_of(s), hosting_step_s=round(step_s, 3),
          hosting_step_share=round(step_s / s["wall_seconds"], 4),
          op_replay_s=round(flush_s, 3),
          bytes_recv_servers=recv, exits_clean=len(hosted),
          capacity=json.dumps({r["array"]: r["peak"] for r in cap},
                              separators=(",", ":")))
    return res, chain


def _state_records(chain):
    """A digest chain's records without what depends on the process:
    each shim child's request-stream hash covers its virtual fd numbers,
    which are real kernel fds and so follow the fds the simulating
    process holds (a run on the card and its CPU twin are two
    processes); the records' state sections and the op-stream digest
    do not."""
    out = []
    for line in chain.splitlines():
        rec = json.loads(line)
        rec.pop("chain")
        rec["sections"].pop("hosted")
        rec["hosted"].pop("shim", None)
        out.append(rec)
    return out


def shim64_compare(gpu_child, child, canonicalize_state):
    """hosted-shim-64's CPU twin equals the card's run: stats, windows,
    Hosts fields, the digest records' state sections, the op-stream
    digest and every child's output."""
    (err, gpu), _ = gpu_child.result()
    if err:
        fail(f"hosted-shim-64: {err}")
    ((gst, ga, gs, ghosted, gdig, _, gouts, _), gchain) = gpu
    (err, res, chain), waited = child.result()
    if err:
        fail(f"hosted-shim-64 cpu twin: {err}")
    cst, ca, cs, chosted, cdig, _, couts, _ = res
    raw = _same_on_both("hosted-shim-64", (gst, ga), (cst, ca),
                        canonicalize_state)
    if gs["windows"] != cs["windows"]:
        fail(f"hosted-shim-64: {gs['windows']} windows on cuda, "
             f"{cs['windows']} on cpu")
    if gdig["ops"] != cdig["ops"] or _state_records(gchain) != \
            _state_records(chain):
        fail("hosted-shim-64: op-stream digests or digest records differ "
             "between cuda and cpu")
    if gouts != couts or ghosted != chosted:
        fail("hosted-shim-64: child outputs or exit reports differ")
    phase("hosted-shim-64-cpu", waited, cpu_wall=round(cs["wall_seconds"],
                                                        3),
          fields_equal=82, raw_differing=raw, ops_digest=gdig["ops"],
          chain_records=len(chain.splitlines()))


class _App:
    """No-op callbacks of the HostedApp surface."""

    def on_start(self, os):
        pass

    def on_timer(self, os, tag):
        pass

    def on_connected(self, os, sock, **_identity):
        pass

    def on_accept(self, os, sock, tag, **_identity):
        pass

    def on_eof(self, os, sock):
        pass

    def on_sent(self, os, sock):
        pass

    def on_dgram(self, os, sock, src, sport, nbytes, aux):
        pass


class _Pinger(_App):
    """tests/test_torch_hosting.py's UDP pinger: 4 datagrams, 1 s apart."""

    def __init__(self, args):
        self.sent = self.echoed = 0

    def on_start(self, os):
        self.sock = os.udp_open()
        self.on_timer(os, 0)

    def on_timer(self, os, tag):
        os.sendto(self.sock, "srv", 8000, 64, aux=42)
        self.sent += 1
        if self.sent < 4:
            os.timer(10**9)

    def on_dgram(self, os, sock, src, sport, nbytes, aux):
        self.echoed += 1

    def seen(self):
        return self.sent, self.echoed


class _Putter(_App):
    """A 51,200-byte TCP put to srv:80, then close."""

    def __init__(self, args):
        self.done = 0

    def on_start(self, os):
        os.tcp_connect("srv", 80)

    def on_connected(self, os, sock, **_identity):
        os.write(sock, 51200)
        os.close(sock)

    def on_sent(self, os, sock):
        self.done += 1

    def seen(self):
        return self.done


class _SelfChannel(_App):
    """A TCP connection to itself over loopback carrying `args` bytes."""

    def __init__(self, args):
        self.size, self.done, self.eofs = int(args), 0, 0

    def on_start(self, os):
        os.tcp_listen(7000)
        os.tcp_connect(os.host_id, 7000)

    def on_connected(self, os, sock, **_identity):
        os.write(sock, self.size)
        os.close(sock)

    def on_sent(self, os, sock):
        self.done += 1

    def on_eof(self, os, sock):
        self.eofs += 1
        os.close(sock)

    def seen(self):
        return self.done, self.eofs


class _PipeApp(_App):
    """`args` bytes through an os.pipe() pair."""

    def __init__(self, args):
        self.size, self.got, self.eofs = int(args), 0, 0

    def on_start(self, os):
        self.a, self.b = os.pipe()
        os.timer(1000)

    def on_timer(self, os, tag):
        os.write(self.a, self.size)
        os.close(self.a)

    def on_dgram(self, os, sock, src, sport, nbytes, aux):
        self.got += nbytes

    def on_eof(self, os, sock):
        self.eofs += 1
        os.close(sock)

    def seen(self):
        return self.got, self.eofs


def _hosted_shapes():
    """tests/test_torch_hosting.py's shapes -> name -> (scenario maker,
    the hosted host's index, what its app must have seen)."""
    from shadow_tpu_torch.core.config import HostSpec, ProcessSpec, Scenario

    def proc(plugin, start_s, args=""):
        return ProcessSpec(plugin=plugin, start_time=int(start_s * 10**9),
                           arguments=args)

    def scen(stop_s, hosts):
        hosts = hosts + [HostSpec(id=f"pad{i}", processes=[
            proc("pingserver", 1000, "port=9")])
            for i in range(3 - len(hosts))]
        return Scenario(stop_time=stop_s * 10**9,
                        topology_graphml=two_poi_topology(), hosts=hosts)

    srv_bulk = HostSpec(id="srv", processes=[proc("bulkserver", 1,
                                                  "port=80")])
    srv_ping = HostSpec(id="srv", processes=[proc("pingserver", 1,
                                                  "port=8000")])

    def solo(plugin, arg):
        return lambda: scen(10, [HostSpec(id="solo", processes=[
            proc(plugin, 1, arg)])])

    return {
        "udp-ping": (lambda: scen(10, [srv_ping, HostSpec(
            id="cli", processes=[proc("hosted:cs-pinger", 2)])]), 1,
            (4, 4)),
        "tcp-put": (lambda: scen(15, [srv_bulk, HostSpec(
            id="cli", processes=[proc("hosted:cs-putter", 2)])]), 1, 1),
        "hosted+modeled": (lambda: scen(15, [
            HostSpec(id="srv", processes=[
                proc("bulkserver", 1, "port=80"),
                proc("pingserver", 1, "port=8000")]),
            HostSpec(id="cli", processes=[
                proc("ping", 2, "peer=srv port=8000 count=3 interval=1s "
                     "size=64"),
                proc("hosted:cs-putter", 3)])]), 1, 1),
        "loopback": (solo("hosted:cs-selfchannel", "50000"), 0, (1, 2)),
        "pipe": (solo("hosted:cs-pipeapp", "200000"), 0, (200000, 1)),
        "cping": (lambda: scen(8, [srv_ping, HostSpec(
            id="cli", processes=[proc(
                "hosted:cs-cping", 2, "peer=srv port=8000 count=4 "
                "interval_ms=800 size=100")])]), 1, None),
    }


def hosted_gpu_cpu_phase(canonicalize_state):
    """21. the hosted tier on cuda and on cpu: equal stats, windows and
    Hosts fields (wake rings included) and equal app observations."""
    from shadow_tpu_torch import hosting
    from shadow_tpu_torch.apps.base import (APP_BULK_SERVER, APP_HOSTED,
                                            APP_PING, APP_PING_SERVER)
    from shadow_tpu_torch.engine.sim import Simulation
    from shadow_tpu_torch.engine.state import EngineConfig
    from shadow_tpu_torch.hosting import cplugin
    t0 = time.perf_counter()
    for name, cls in (("cs-pinger", _Pinger), ("cs-putter", _Putter),
                      ("cs-selfchannel", _SelfChannel),
                      ("cs-pipeapp", _PipeApp)):
        hosting.register(name, cls)
    cplugin.register_c_plugin(
        "cs-cping", os.path.join(HERE, "examples", "plugins", "cping.c"))
    cfg = EngineConfig(num_hosts=3, qcap=32, scap=8, obcap=16, incap=32,
                       txqcap=8, procs_per_host=2,
                       app_kinds=(0, APP_PING, APP_PING_SERVER,
                                  APP_BULK_SERVER, APP_HOSTED))
    for name, (mk, at, want) in _hosted_shapes().items():
        runs = []
        for device in ("cuda", "cpu"):
            sim = Simulation(mk(), engine_cfg=cfg, device=device)
            app = sim.hosting.apps[at]
            rep = sim.run()
            if hasattr(app, "seen"):
                seen = app.seen()
            else:
                for fn in ("plugin_get_sent", "plugin_get_echoed"):
                    getattr(app.lib, fn).argtypes = [ctypes.c_void_p]
                seen = (app.lib.plugin_get_sent(app.state),
                        app.lib.plugin_get_echoed(app.state))
            runs.append((rep, arrays(sim, rep), seen))
        (grep, ga, gseen), (crep, ca, cseen) = runs
        raw = _same_on_both(f"hosted-gpu=cpu {name}", ga, ca,
                            canonicalize_state)
        if grep.windows != crep.windows or gseen != cseen:
            fail(f"hosted-gpu=cpu {name}: windows {grep.windows}/"
                 f"{crep.windows}, apps saw {gseen}/{cseen}")
        if want is not None and gseen != want:
            fail(f"hosted-gpu=cpu {name}: the app saw {gseen}, not {want}")
        print(f"  {name}: events={grep.events} windows={grep.windows} "
              f"app_saw={gseen} cuda_wall={grep.wall_seconds:.3f}s "
              f"cpu_wall={crep.wall_seconds:.3f}s fields_equal=82 "
              f"raw_differing={raw}", flush=True)
    phase("hosted-gpu=cpu", time.perf_counter() - t0)


def profile_run(only):
    """--profile: wall split and profiler runs of phold-4096 and
    gossip-100k (socks10k's profiled span is part of its phase)."""
    if only is None or "phold-4096" in only:
        profile_cell("phold-4096", lambda: phold_scenario(4096, 5),
                     phold_cfg(4096))
    if only is None or "gossip-100k" in only:
        profile_cell("gossip-100k", lambda: gossip_scenario(100_000),
                     gossip_cfg(100_000))


def main():
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device; nothing to check\n")
        return 2
    from shadow_tpu_torch.core import rng as R
    from shadow_tpu_torch.engine import defs
    from shadow_tpu_torch.engine.window import canonicalize_state

    t_all = time.perf_counter()
    os.environ.setdefault(T0_ENV, str(time.time()))
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device_count {torch.cuda.device_count()} kind {kind!r}",
          flush=True)
    check_graph_runs()

    args = sys.argv[1:]
    only = None
    if "--phases" in args:
        only = set(args[args.index("--phases") + 1].split(","))
    if "--profile" in args:
        profile_run(only)
        return 0

    def want(name):
        return only is None or name in only

    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return _phases(want, only, canonicalize_state, defs, R, kind,
                       t_all, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phases(want, only, canonicalize_state, defs, R, kind, t_all, tmp):
    # 2.-4., 18., 22. and 24. the timed phases, alone on the card
    import multiprocessing as mp

    from shadow_tpu_torch.__main__ import main as cli
    from shadow_tpu_torch.core import kernels as K
    # 30. first: it builds the kernel library (or loads it)
    figures = flow_kernels_phase() if want("flow-kernels") else None
    if want("ping"):
        ping_phase(cli)
    # 3. is the main path whose kernel launches the kernels line counts
    timed_phold = launches = None
    executions, by_path = {}, {}
    if want("phold-4096"):
        K.executions(reset=True)
        K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
        timed_phold = phold_phase()
        launches = by_path["phold-4096"] = dict(K.LAUNCHES)
        ex = count_executions("phold-4096", timed_phold)
        executions.update(pass_flags=ex["pass_flags"], advance=ex["advance"])
        if not (launches["pass_flags"] and launches["advance"]
                and executions["pass_flags"] and executions["advance"]):
            fail(f"phold-4096 did not go through every kernel: launches "
                 f"{launches}, executions {ex}")
    if want("passcope"):
        passcope_phase()
    if want("batch-phold-4096x4"):
        # 24.'s batch is the main path of advance_lanes' launches
        batch, lanes = batch_phase()
        by_path["batch-phold-4096x4"] = lanes
        ex = count_executions("batch-phold-4096x4", batch)
        executions["advance_lanes"] = ex["advance_lanes"]
        if launches is not None:
            launches = dict(launches, advance_lanes=lanes["advance_lanes"])
        if not (lanes["advance_lanes"] and lanes["pass_flags"]
                and ex["advance_lanes"] and ex["pass_flags"]):
            fail(f"batch-phold-4096x4 did not go through its kernels: "
                 f"launches {lanes}, executions {ex}")
    plain_gossip = gossip_phase() if want("gossip-100k") else None
    if want("gossip-100k-telemetry"):
        gossip_telemetry_phase(plain_gossip)
    # 5., 23. and 6. alone too: on the graph path they take a minute or
    # so, where the eager loop took minutes beside other processes
    if want("socks10k"):
        census_phase(socks10k_phase(defs))
    if want("tgen-1k"):
        tgen1k_phase(defs)
    if only and "tgen-1k-cpu" in only:
        tgen1k_cpu_phase(canonicalize_state)
    if only and "paths-alone" in only:
        paths_alone_phase()

    # 7., 13. (with its CPU halves), 17., 20. (with its CPU twin) and
    # 26.-27. in processes of their own on the same card, beside 8.-12.,
    # 14.-16., 19., 21. and 28.-32.: the eager phases among them are
    # host-bound, and the card serves a few such processes at about the
    # speed of one each (PERF.md §6); all in one process the script
    # would run past its time limit
    faults = (Child(_socks10k_faults_child, "socks10k-faults")
              if want("socks10k-faults") else None)
    tgen_cli = CliTgen() if want("cli-tgen") else None
    tgen = (Child(_tgen_gpu_cpu_child, "tgen-gpu=cpu")
            if want("tgen-gpu=cpu") else None)
    fleet = Child(_fleet_child, "fleet") if want("fleet") else None
    shim_gpu = shim_cpu = None
    if want("hosted-shim-64"):
        shim_gpu = Child(_shim64_gpu_child, "hosted-shim-64")
        shim_cpu = Child(_shim64_cpu_child, "hosted-shim-64-cpu")
    single_chain = os.path.join(tmp, "phold-single.jsonl")
    meshes = None
    if want("mesh-phold-4096x4") or want("mesh-gossip-100k"):
        meshes = Child(_mesh_child, "mesh-phold-4096x4/mesh-gossip-100k",
                       args=(want("mesh-phold-4096x4") and
                             _single_of(timed_phold), single_chain,
                             want("mesh-gossip-100k") and
                             _single_of(plain_gossip), tmp))
    mesh_tcp_cpu = (Child(_mesh_tcp_cpu_child, "mesh-tcp-gpu=cpu (cpu)",
                          args=(os.path.join(tmp, "mesh-tcp-cpu.jsonl"),))
                    if want("mesh-tcp-gpu=cpu") else None)
    dist_ranks, dist_chain = [], None
    try:
        if want("log1p"):
            log1p_phase(R)
        if want("gpu=cpu"):
            udp_gpu_cpu_phase(canonicalize_state)
        if want("cbrt"):
            cbrt_phase()
        if want("tcp-gpu=cpu"):
            tcp_gpu_cpu_phase(canonicalize_state)
        if want("cli-tcp"):
            cli_tcp_phase(cli)
        if want("faults-demo"):
            faults_demo_phase(cli)
        if want("ckpt-gpu=cpu"):
            ckpt_gpu_cpu_phase()
        if want("cpu-model-gpu=cpu"):
            cpu_model_gpu_cpu_phase()
        if want("telemetry-gpu=cpu"):
            telemetry_gpu_cpu_phase(canonicalize_state)
        if want("hosted-gpu=cpu"):
            hosted_gpu_cpu_phase(canonicalize_state)
        if want("graph=eager"):
            graph_eager_phase(canonicalize_state)
        if want("aot-cache"):
            aot_cache_phase()
        # 29.'s ranks start last, so that they load the host only while
        # this process would otherwise wait for the children
        if want("dist-phold"):
            dist_ranks, dist_chain = dist_phold_start(tmp)
        if mesh_tcp_cpu:
            mesh_tcp_phase(mesh_tcp_cpu, tmp)
        single_phold = None
        if meshes:
            (err, got), _ = meshes.result()
            if err:
                fail(f"{meshes.name}: {err}")
            single_phold, mesh_launches = got
            if mesh_launches:
                by_path["mesh-phold-4096x4"] = mesh_launches
        if dist_ranks:
            dist_phold_finish(dist_ranks, dist_chain,
                              single_phold, single_chain)
        for child in (tgen, faults):
            if child:
                err, _ = child.result()
                if err:
                    fail(f"{child.name}: {err}")
        if tgen_cli:
            tgen_cli.finish()
        if fleet:
            fleet_finish(fleet)
        if shim_gpu:
            shim64_compare(shim_gpu, shim_cpu, canonicalize_state)
    finally:
        for child in (tgen_cli, tgen, faults, fleet,
                      shim_gpu, shim_cpu, meshes, mesh_tcp_cpu,
                      *dist_ranks):
            if child:
                child.stop()

    print(f"total wall {time.perf_counter() - t_all:.1f}s")
    if (figures is not None and launches is not None
            and "advance_lanes" in executions):
        print(json.dumps(kernels_line(figures, launches, executions,
                                      by_path)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def passcope_phase(device="cuda", n=4096):
    """22. passcope on phold-4096 to PASSCOPE_STOP_S: a plain run, then
    a run tracing its first PASSCOPE_WINDOWS windows (one chunk); equal
    results and >= 90% attributed."""
    import dataclasses
    import tempfile

    from shadow_tpu_torch.engine.sim import Simulation
    from shadow_tpu_torch.obs import passcope as PC
    cfg = dataclasses.replace(phold_cfg(n), chunk_windows=PASSCOPE_WINDOWS)
    t0 = time.perf_counter()
    _, plain = run(phold_scenario(n, PASSCOPE_STOP_S), cfg, device)
    t1 = time.perf_counter()
    os.environ["SHADOW_TPU_PASSCOPE_CHUNKS"] = "1"
    try:
        with tempfile.TemporaryDirectory() as d:
            sim = Simulation(phold_scenario(n, PASSCOPE_STOP_S),
                             engine_cfg=cfg, device=device)
            rep = sim.run(passcope=d)
    finally:
        del os.environ["SHADOW_TPU_PASSCOPE_CHUNKS"]
    t2 = time.perf_counter()
    dev = rep.device_phases
    if not dev.get("available"):
        fail(f"passcope: no pass table: {dev}")
    if (not (rep.stats == plain.stats).all()
            or (rep.windows, rep.passes) != (plain.windows, plain.passes)):
        fail("passcope: the profiled run's results differ from the plain "
             "run's")
    print(PC.format_report(dev, rep.occupancy), flush=True)
    if not dev["ok"] or dev["attributed_frac"] < PC.MIN_ATTRIBUTED:
        fail(f"passcope: only {dev['attributed_frac']} of the "
             f"{dev['device']} time attributed: {dev['residual_top']}")
    table = {k: [v["ms"], v["host_ms"], v["sync_ms"]]
             for k, v in dev["phases"].items()}
    phase("passcope", time.perf_counter() - t0,
          plain_wall_s=round(t1 - t0, 3), passcope_wall_s=round(t2 - t1, 3),
          run_wall_s=round(rep.wall_seconds, 3), windows=rep.windows,
          passes=rep.passes, events=rep.events,
          chunks_traced=dev["chunks_traced"], total_ms=dev["total_ms"],
          attributed_frac=dev["attributed_frac"],
          runtime_ms=dev["runtime_ms"],
          label_ms_host_sync=json.dumps(table, separators=(",", ":")))


def census_phase(socks):
    """23. the state census of socks10k's run beside the allocator's
    peak."""
    if socks is None:
        return
    sim, rep = socks
    mem = rep.memory
    c = mem["census"]
    live = sum(t.numel() * t.element_size()
               for t in vars(sim.final_hosts).values())
    if c["hosts"]["bytes"] != live:
        fail(f"census: Hosts {c['hosts']['bytes']} bytes, tensors {live}")
    peak = torch.cuda.max_memory_allocated()
    if not c["bytes"] <= mem["peak_bytes"] <= peak:
        fail(f"census: state {c['bytes']} bytes, run peak "
             f"{mem['peak_bytes']}, allocator peak {peak}")
    phase("census", 0.0, hosts=c["H"], state_bytes=c["bytes"],
          state_bytes_per_host=c["per_host"],
          hosts_bytes=c["hosts"]["bytes"], hp_bytes=c["hp"]["bytes"],
          shared_bytes=c["shared"]["bytes"],
          hot_state_bytes=mem["hot_state_bytes"],
          run_peak_bytes=mem["peak_bytes"], max_memory_allocated=peak,
          sections=json.dumps(mem["sections"], separators=(",", ":")))


def batch_of(reps, name):
    """The graph path's figures of a card batch, which must have taken
    it (one replay and one host read a chunk), as phase-line fields."""
    ex = reps[0].execution
    if not (ex.get("path") == "graph" and ex["host_reads_per_chunk"] == 1.0
            and ex["replays"] == ex["chunks"]):
        fail(f"{name}: the card's batch ran {ex}")
    return {"path": "graph", "captures": ex["captures"],
            "capture_wall_s": round(ex["capture_wall_s"], 3),
            "replays": ex["replays"],
            "host_reads_per_chunk": ex["host_reads_per_chunk"],
            "pool_bytes": ex["pool_bytes"]}


def batch_phase(device="cuda", n=4096, seeds=(1, 2, 3, 4)):
    """24. batch-phold-4096x4 on the graph path: each lane equals its
    seed's run alone -> (the stacked passes and the lanes' windows, the
    kernels' launches in the batch's run; the device's execution counts
    are left as that run made them)."""
    import tempfile
    import types

    from shadow_tpu_torch.core import kernels as K
    from shadow_tpu_torch.engine.sim import Simulation
    from shadow_tpu_torch.serving.batch import run_batch
    t0 = time.perf_counter()

    def scen(seed):
        sc = phold_scenario(n, BATCH_STOP_S)
        sc.seed = seed
        return sc

    with tempfile.TemporaryDirectory() as d:
        alone = {}
        for sd in seeds:
            sim = Simulation(scen(sd), engine_cfg=phold_cfg(n),
                             device=device)
            alone[sd] = sim.run(digest=os.path.join(d, f"one{sd}.jsonl"))
        t1 = time.perf_counter()
        sims = [Simulation(scen(sd), engine_cfg=phold_cfg(n),
                           device=device) for sd in seeds]
        # the kernels' counts of the batch alone, for the kernels line
        K.executions(reset=True)
        K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
        reps = run_batch(sims, digest_paths=[
            os.path.join(d, f"lane{sd}.jsonl") for sd in seeds])
        launches = dict(K.LAUNCHES)
        t2 = time.perf_counter()
        for sd, rep in zip(seeds, reps):
            one = alone[sd]
            with open(os.path.join(d, f"one{sd}.jsonl"), "rb") as f:
                want = f.read()
            with open(os.path.join(d, f"lane{sd}.jsonl"), "rb") as f:
                got = f.read()
            if got != want or not want:
                fail(f"batch-phold-{n}x{len(seeds)}: lane of seed {sd}: "
                     "digest chain differs from its run alone")
            if (not (rep.stats == one.stats).all()
                    or (rep.windows, rep.passes)
                    != (one.windows, one.passes)):
                fail(f"batch-phold-{n}x{len(seeds)}: lane of seed {sd}: "
                     "stats, windows or passes differ from its run alone")
    name = f"batch-phold-{n}x{len(seeds)}"
    events = sum(r.events for r in reps)
    wall = reps[0].wall_seconds
    walls = [round(alone[sd].wall_seconds, 3) for sd in seeds]
    phase(name, time.perf_counter() - t0,
          batch_wall_s=round(wall, 3),
          events=events, events_per_s=round(events / wall, 1),
          stacked_passes=reps[0].batch["stacked_passes"],
          lane_passes=[r.passes for r in reps],
          lane_windows=[r.windows for r in reps],
          alone_wall_s=json.dumps(walls),
          alone_wall_sum_s=round(sum(walls), 3),
          alone_events_per_s=json.dumps(
              [round(alone[sd].events_per_sec, 1) for sd in seeds]),
          alone_phase_s=round(t1 - t0, 3),
          batch_phase_s=round(t2 - t1, 3), **batch_of(reps, name))
    return types.SimpleNamespace(passes=reps[0].batch["stacked_passes"],
                                 windows=max(r.windows for r in reps)), \
        launches


def paths_alone_phase(seeds=(1, 2, 3, 4)):
    """--phases paths-alone: the cells that take the graph path as a
    batch or a one-card mesh — batch-phold-4096x4, mesh-phold-4096x4,
    mesh-gossip-100k — each run on the graph path and then with
    ``graph=False``, alone in this process: equal stats,
    windows and passes; prints both walls and host reads a chunk. The
    kernel library is built or loaded first, outside the walls (each
    graph wall holds its capture, as a run's does)."""
    from shadow_tpu_torch.core import kernels as K
    from shadow_tpu_torch.engine.sim import Simulation
    from shadow_tpu_torch.parallel.shard import make_mesh
    from shadow_tpu_torch.serving.batch import run_batch
    t0 = time.perf_counter()
    K.lib()

    def lanes(graph):
        sims = []
        for sd in seeds:
            scen = phold_scenario(4096, BATCH_STOP_S)
            scen.seed = sd
            sims.append(Simulation(scen, engine_cfg=phold_cfg(4096),
                                   device="cuda"))
        reps = run_batch(sims, graph=graph)
        return (reps[0].wall_seconds, reps[0].execution,
                [(r.stats, r.windows, r.passes) for r in reps])

    def mesh(mk, cfg, graph):
        _, rep = run(mk(), cfg, "cuda", mesh=make_mesh(MESH_SHARDS, "cuda"),
                     graph=graph)
        return (rep.wall_seconds, rep.execution,
                [(rep.stats, rep.windows, rep.shard_passes)])

    cells = (
        ("batch-phold-4096x4", lanes),
        ("mesh-phold-4096x4", lambda g: mesh(
            lambda: phold_scenario(4096, 5), phold_cfg(4096), g)),
        ("mesh-gossip-100k", lambda g: mesh(
            lambda: gossip_scenario(100_000), gossip_cfg(100_000), g)))
    out = {}
    for name, fn in cells:
        (gw, gex, gres), (ew, eex, eres) = fn(True), fn(False)
        if gex["path"] != "graph" or eex["path"] != "eager" or any(
                not (a[0] == b[0]).all() or a[1:] != b[1:]
                for a, b in zip(gres, eres)):
            fail(f"paths-alone {name}: the paths differ ({gex['path']}, "
                 f"{eex['path']})")
        out[name] = {"graph_wall_s": round(gw, 3),
                     "eager_wall_s": round(ew, 3),
                     "eager_host_reads_per_chunk":
                         round(eex["host_reads_per_chunk"], 1)}
    phase("paths-alone", time.perf_counter() - t0,
          walls=json.dumps(out, separators=(",", ":")))


def fleet_run(device="cuda"):
    """25. the fleet on `device`: two runs and a two-member batch group
    under ``fleet run --workers 2``, each chain against its run alone
    -> a dict of figures (raises on a failed check)."""
    import tempfile

    from shadow_tpu_torch.__main__ import main as cli
    from shadow_tpu_torch.fleet import cli as FC
    from shadow_tpu_torch.fleet.queue import Queue
    caps = "qcap=16,scap=4,obcap=8,incap=16,chunk=8"
    with tempfile.TemporaryDirectory() as d:
        xml = os.path.join(d, "phold.xml")
        with open(xml, "w") as f:
            f.write(phold_scenario(8, 6, bw_kib=10240,
                                   mean="300ms").to_xml())
        qdir = os.path.join(d, "q")
        alone = {"m7": ["--seed", "7", "--engine-caps", caps],
                 "m8": ["--seed", "8", "--engine-caps", caps],
                 "phold-s1": ["--seed", "1"], "phold-s2": ["--seed", "2"]}
        with contextlib.redirect_stdout(io.StringIO()):
            for rid in ("m7", "m8"):
                if FC.main(["submit", qdir, xml, "--id", rid, "--device",
                            device, "--digest-every", "8", "--"]
                           + alone[rid]):
                    raise RuntimeError(f"fleet submit {rid} failed")
            if FC.main(["submit", qdir, xml, "--batch", "g", "--seeds",
                        "1,2", "--device", device, "--digest-every", "8"]):
                raise RuntimeError("fleet submit --batch failed")
        env = dict(os.environ, PYTHONPATH=HERE)
        env.pop(T0_ENV, None)
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "shadow_tpu_torch", "fleet", "run",
             qdir, "--workers", "2", "--backoff", "0.1"], cwd=HERE,
            env=env, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise RuntimeError(f"fleet run rc={r.returncode}: "
                               f"{(r.stdout + r.stderr)[-2000:]}")
        q = Queue(qdir)
        states = q.fold()
        bad = {k: (v.state, v.crashes) for k, v in states.items()
               if v.state != "done" or v.crashes}
        if set(states) != set(alone) or bad:
            raise RuntimeError(f"fleet: runs not all done cleanly: {bad}")
        for rid, args in alone.items():
            dg = os.path.join(d, f"alone-{rid}.jsonl")
            with contextlib.redirect_stdout(io.StringIO()):
                if cli([xml, "--device", device, "--digest", dg,
                        "--digest-every", "8"] + args):
                    raise RuntimeError(f"fleet: {rid} alone failed")
            with open(dg, "rb") as f1, open(q.digest_path(rid), "rb") as f2:
                if f1.read() != f2.read():
                    raise RuntimeError(f"fleet: {rid}'s chain differs "
                                       "from its run alone")
        return {"fleet_run_wall_s": round(wall, 3), "runs": len(states),
                "chains_equal": len(alone)}


def _fleet_child(conn):
    """A child process: phase 25 -> (None, figures), or the failure."""
    t0 = time.perf_counter()
    try:
        out = fleet_run()
        out["wall"] = time.perf_counter() - t0
        conn.send((None, out))
    except BaseException as e:
        conn.send((f"{type(e).__name__}: {e}", None))
        raise


def fleet_finish(child):
    (err, out), waited = child.result()
    if err:
        fail(f"fleet: {err}")
    wall = out.pop("wall")
    phase("fleet", wall, waited_s=round(waited, 3), **out)


def log1p_phase(R):
    t0 = time.perf_counter()
    u = (torch.arange(1 << 24, dtype=torch.int64).to(torch.float32)
         * (1.0 / (1 << 24)))
    # the CPU side in cache-sized chunks (same values, a fifth of the wall)
    cpu_bits = torch.cat([R.log1p_f32(-x) for x in u.split(1 << 18)]
                         ).view(torch.int32)
    gpu_bits = R.log1p_f32(-u.cuda()).view(torch.int32).cpu()
    diff = int((cpu_bits != gpu_bits).sum())
    if diff:
        fail(f"log1p_f32 cuda != cpu on {diff} of 2^24 inputs")
    phase("log1p", time.perf_counter() - t0, inputs=1 << 24, mismatches=0)


def ping_phase(cli):
    """2. ping through the CLI entry point: mean RTT exactly 50 ms."""
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli([os.path.join(HERE, "examples", "ping.xml"),
                  "--summary-json", "--device", "cuda"])
    s = json.loads(out.getvalue().strip().splitlines()[-1])
    if rc != 0 or s["mean_rtt_us"] != 50000 or s["device"] != "cuda":
        fail(f"ping: rc={rc} mean_rtt_us={s['mean_rtt_us']} "
             f"device={s['device']}")
    phase("ping", time.perf_counter() - t0, events=s["events"],
          mean_rtt_us=s["mean_rtt_us"])


def phold_phase():
    """3. phold-4096, bench.py's shape, 5 sim-s."""
    from shadow_tpu_torch.engine import defs
    t0 = time.perf_counter()
    _, rep = run(phold_scenario(4096, 5), phold_cfg(4096), "cuda")
    s = rep.summary()
    per_host = rep.stats[:, defs.ST_EVENTS]
    if not (s["drop_net"] == 0 and
            0 <= s["pkts_sent"] - s["pkts_recv"] <= 4096 * 4 and
            s["pkts_sent"] > 4096 and (per_host > 0).all()):
        fail(f"phold-4096 conservation: {s}")
    phase("phold-4096", time.perf_counter() - t0, **rates(rep),
          pkts_sent=s["pkts_sent"], pkts_recv=s["pkts_recv"],
          **graph_of(rep, "phold-4096"))
    return rep


def gossip_phase():
    """4. gossip-100k as written, full 30 sim-s."""
    from shadow_tpu_torch.core import kernels as K
    from shadow_tpu_torch.engine import defs
    t0 = time.perf_counter()
    K.executions(reset=True)
    gsim, rep = run(gossip_scenario(100_000), gossip_cfg(100_000), "cuda")
    count_executions("gossip-100k", rep)
    s = rep.summary()
    mined = int(gsim.final_hosts.app_r[0, 0, 4])
    seen = rep.stats[1:, defs.ST_XFER_DONE]
    share = float((seen == mined).mean())
    if not (mined >= 2 and share >= 0.999 and s["drop_net"] == 0):
        fail(f"gossip-100k: mined={mined} share={share} {s}")
    phase("gossip-100k", time.perf_counter() - t0, **rates(rep),
          blocks=mined, full_share=round(share, 6),
          mean_prop_delay_us=round(s["mean_rtt_us"], 1),
          **graph_of(rep, "gossip-100k"))
    return rep


# --- the chunk graph (core/flow.py, core/kernels.py, core/jitcache.py) -----

# the card's peak memory rate (NVIDIA's data sheet, H100 SXM), for the
# kernels' bounds: both move bytes and do a few integer operations a row
HBM_BYTES_PER_S = 3.35e12
KERNEL_SOURCE = "shadow_tpu_torch/csrc/flow.cu"
KERNEL_ROWS = (4096, 10_000, 100_000)     # phold-4096, socks10k, gossip-100k
# the row counts the kernels are held at: one row, a ragged 16-byte tail,
# a block's width and one past it, the main path's counts and one past
CHECK_ROWS = (1, 3, 1023, 1025, 4096, 4097, 10_000, 16_384, 100_000,
              100_003)
# advance_lanes: the lane counts and rows a lane it is held at (among
# them the timed shapes' rows, and one past each), and the batch shapes
# it is timed at (batch-phold-4096x4, the main path of its launches;
# four gossip-100k-sized lanes)
LANE_CHECK = ((1, 2, 4, 7), (1, 3, 1025, 4096, 4097, 25_000, 25_001))
LANE_SHAPES = ((4, 4096), (4, 25_000))
GRAPH_EXECS = 64        # executions of each kernel in the checked graph
GRAPH_LAUNCHES = 200    # launches of a kernel in a timed graph
# the cells whose executions a pass and a window the kernels line gives
CELL_EXECS = {}


def _time_ms(fn, reps=200):
    """Mean ms a call of `fn` over `reps` calls, by CUDA events."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _replays_ms(replay, launches, reps=5):
    """Mean ms a launch of a graph of `launches` launches: one untimed
    `replay`, then `reps` timed by CUDA events."""
    replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (launches * reps)


def _graph_ms(fn, launches=GRAPH_LAUNCHES):
    """Mean ms a launch of `fn` inside a CUDA graph of `launches` calls."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    return _replays_ms(g.replay, launches)


def _body_graph_ms(fn, launches=GRAPH_LAUNCHES):
    """Mean ms a launch of `fn` inside a conditional body: `launches`
    calls under one ``flow.when`` on a flag that is set, captured as the
    chunk is (``core.jitcache.capture``)."""
    from shadow_tpu_torch.core import flow as FL
    from shadow_tpu_torch.core import jitcache as JC
    on = torch.ones(1, dtype=torch.int32, device="cuda")

    def body():
        @FL.when(on)
        def _():
            for _ in range(launches):
                fn()
    g = JC.capture(body, on.device, keep=(on,))
    try:
        return _replays_ms(g.replay, launches)
    finally:
        g.close()


def _kernel_inputs(H, seed, offset=0):
    """Rows of a drain pass and a window boundary at H hosts, from a
    seed: pass codes (half the rows idle), TCP-part feature words, the
    queues' next events, the outboxes' next arrivals and counts; each
    a view `offset` elements into a larger tensor."""
    from shadow_tpu_torch.engine.defs import EV_NULL
    from shadow_tpu_torch.engine.window import _N_CODES
    rng = np.random.RandomState(seed)
    code = np.where(rng.rand(H) < 0.5, EV_NULL,
                    rng.randint(0, _N_CODES, H)).astype(np.int32)
    feat = ((rng.rand(H, 11) < 0.01) << np.arange(11)).sum(1).astype(
        np.int32)
    eq = rng.randint(0, 5 * 10**9, H).astype(np.int64)
    eq[rng.rand(H) < 0.3] = (1 << 63) - 1
    ob = rng.randint(0, 5 * 10**9, H).astype(np.int64)
    ob[rng.rand(H) < 0.7] = (1 << 63) - 1
    cnt = rng.randint(0, 3, H).astype(np.int32)
    return [torch.from_numpy(np.concatenate([np.zeros(offset, v.dtype),
                                             v])).cuda()[offset:]
            for v in (code, feat, eq, ob, cnt)]


def _window_in(K):
    """A window's scalars at 2 sim-s, the stop time 5 sim-s, 8 windows
    a chunk, 5 packets shipped: every advance mode has work."""
    from shadow_tpu_torch.engine.window import window_scalars
    W = window_scalars(2 * 10**9, 2 * 10**9 + 10**7, 5 * 10**9, 10**7, 8)
    W[K.W_OB0] = 5
    return W.cuda()


def _flag_args(code, feat, stop):
    """pass_flags' arguments as the drain gives them, with a stop bit
    among the feature bits when `stop`; without feature words when
    `feat` is None."""
    from shadow_tpu_torch.engine.defs import EV_NULL
    from shadow_tpu_torch.engine.window import _N_CODES
    if feat is None:
        return (code, None, _N_CODES, 0, EV_NULL, 0, 0)
    return (code, feat, _N_CODES, 11, EV_NULL, 1 << 10, (1 << 3) * stop)


def _kernel_errors(K, H, seed, offset):
    """Each kernel against its plain version on one input set -> the
    largest absolute differences (pass_flags, advance)."""
    code, feat, eq, ob, cnt = _kernel_inputs(H, seed, offset)
    err_f = err_a = 0
    for f, stop in ((feat, 0), (feat, 1), (None, 0)):
        args = _flag_args(code, f, stop)
        err_f = max(err_f, int((K.pass_flags(*args)
                                - K.pass_flags_plain(*args)).abs().max()))
    W0 = _window_in(K)
    for mode in (K.ADV_OPEN, K.ADV_SHIP, K.ADV_STEP):
        g = K.advance(eq, ob, cnt, W0.clone(), mode)
        w = K.advance_plain(eq, ob, cnt, W0.clone(), mode)
        err_a = max(err_a, int((g - w).abs().max()))
    return err_f, err_a


def _graph_errors(K):
    """GRAPH_EXECS executions of each kernel captured in one graph,
    each with its own inputs and outputs (the CHECK_ROWS row counts in
    turn, every other one a view one element in; the advance modes in
    turn), replayed twice -> the largest absolute differences from the
    plain versions: partials or counters left dirty from one execution
    to the next would show."""
    cases = [(_kernel_inputs(CHECK_ROWS[i % len(CHECK_ROWS)], 1000 + i,
                             i % 2), i % 3)
             for i in range(GRAPH_EXECS)]
    W0 = _window_in(K)
    Ws = [W0.clone() for _ in cases]
    flags = []
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for ((code, feat, eq, ob, cnt), mode), W in zip(cases, Ws):
            flags.append(K.pass_flags(*_flag_args(code, feat, mode == 2)))
            K.advance(eq, ob, cnt, W, mode)
    err_f = err_a = 0
    for _ in range(2):
        for W in Ws:
            W.copy_(W0)
        g.replay()
        torch.cuda.synchronize()
        for ((code, feat, eq, ob, cnt), mode), W, got in zip(cases, Ws,
                                                            flags):
            want = K.pass_flags_plain(*_flag_args(code, feat, mode == 2))
            err_f = max(err_f, int((got - want).abs().max()))
            w = K.advance_plain(eq, ob, cnt, W0.clone(), mode)
            err_a = max(err_a, int((W - w).abs().max()))
    return err_f, err_a


def _lane_inputs(K, B, H, seed, offset=0):
    """advance_lanes' inputs for B lanes of H rows from a seed: the rows
    (each a view `offset` elements in) and the lanes' window scalars,
    lane b's window at 2 sim-s + b x 10 ms (`_window_in`), every third
    lane frozen."""
    *_, eq, ob, cnt = _kernel_inputs(B * H, seed, offset)
    W = _window_in(K).repeat(B, 1)
    W[:, K.W_CONT] = 1
    W[::3, K.W_CONT] = 0
    W[:, K.W_WS] += 10**7 * torch.arange(B, device=W.device)
    return eq, ob, cnt, W


def _lane_errors(K, B, H, seed, offset):
    """advance_lanes against its plain version on one input set, every
    mode, eagerly -> the largest absolute difference (W and G)."""
    eq, ob, cnt, W0 = _lane_inputs(K, B, H, seed, offset)
    err = 0
    for mode in (K.ADV_OPEN, K.ADV_SHIP, K.ADV_STEP):
        got = [W0.clone(), torch.zeros(K.W_LEN + 1, dtype=torch.int64,
                                       device="cuda")]
        want = [t.clone() for t in got]
        K.advance_lanes(eq, ob, cnt, *got, mode)
        K.advance_lanes_plain(eq, ob, cnt, *want, mode)
        err = max([err] + [int((a - b).abs().max())
                           for a, b in zip(got, want)])
    return err


def _lane_graph_errors(K):
    """An execution of advance_lanes in one graph for every LANE_CHECK
    shape, contiguous and on views one element in (the modes in turn),
    replayed twice -> the largest absolute difference from the plain
    version: a ticket left dirty would show."""
    shapes = [(B, H, off) for B in LANE_CHECK[0] for H in LANE_CHECK[1]
              for off in (0, 1)]
    cases = [(_lane_inputs(K, B, H, 3000 + i, off), i % 3)
             for i, (B, H, off) in enumerate(shapes)]
    outs = [(W0.clone(), torch.zeros(K.W_LEN + 1, dtype=torch.int64,
                                     device="cuda"))
            for (*_, W0), _ in cases]
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for ((eq, ob, cnt, _), mode), (W, G) in zip(cases, outs):
            K.advance_lanes(eq, ob, cnt, W, G, mode)
    err = 0
    for _ in range(2):
        for ((*_, W0), _), (W, G) in zip(cases, outs):
            W.copy_(W0)
            G.zero_()
        g.replay()
        torch.cuda.synchronize()
        for ((eq, ob, cnt, W0), mode), (W, G) in zip(cases, outs):
            want = [W0.clone(), torch.zeros_like(G)]
            K.advance_lanes_plain(eq, ob, cnt, *want, mode)
            err = max(err, int((W - want[0]).abs().max()),
                      int((G - want[1]).abs().max()))
    return err


def flow_kernels_phase():
    """30. the chunk's three hand-written kernels against their plain
    versions on the card, bits equal, at CHECK_ROWS (advance_lanes at
    LANE_CHECK's lanes and rows a lane; contiguous and on views one
    element in) and across GRAPH_EXECS executions in one graph
    (advance_lanes: one a LANE_CHECK shape and offset); their
    times at the main paths' row counts (advance_lanes at LANE_SHAPES),
    eager (`ms`) and in a graph (`graph_ms`), beside an empty kernel's
    in a graph (`floor_ms`), the plain versions' and the bounds ->
    {kernel: figures at the largest row count (advance_lanes: at its
    main path's shape), with graph_ms at each}."""
    from shadow_tpu_torch.core import kernels as K
    from shadow_tpu_torch.engine.window import _N_CODES
    t0 = time.perf_counter()
    launches0 = dict(K.LAUNCHES)
    for H in CHECK_ROWS:
        for offset in (0, 1):
            err = _kernel_errors(K, H, H + offset, offset)
            if any(err):
                fail(f"flow-kernels: kernel != plain at H={H} offset="
                     f"{offset}: pass_flags {err[0]}, advance {err[1]}")
    err = _graph_errors(K)
    if any(err):
        fail(f"flow-kernels: kernel != plain across {GRAPH_EXECS} "
             f"executions in one graph: pass_flags {err[0]}, advance "
             f"{err[1]}")
    max_err = dict(zip(("pass_flags", "advance"), err))
    lane_err = max(_lane_errors(K, B, H, B * H + off, off)
                   for B in LANE_CHECK[0] for H in LANE_CHECK[1]
                   for off in (0, 1))
    if lane_err:
        fail(f"flow-kernels: advance_lanes != plain by {lane_err}")
    max_err["advance_lanes"] = _lane_graph_errors(K)
    if max_err["advance_lanes"]:
        fail(f"flow-kernels: advance_lanes != plain across "
             f"{2 * len(LANE_CHECK[0]) * len(LANE_CHECK[1])} executions "
             f"in one graph: {max_err['advance_lanes']}")

    def empty():
        K.check(K.lib().sf_empty(torch.cuda.current_stream().cuda_stream,
                                 1, 1), "empty kernel")
    floor_ms = _graph_ms(empty)
    floor_body_ms = _body_graph_ms(empty)
    out, rows = {}, []
    for H in KERNEL_ROWS:
        code, feat, eq, ob, cnt = _kernel_inputs(H, H)
        args = _flag_args(code, feat, 0)
        W = _window_in(K)
        fig = {
            "pass_flags": dict(
                ms=_time_ms(lambda: K.pass_flags(*args)),
                graph_ms=_graph_ms(lambda: K.pass_flags(*args)),
                plain_ms=_time_ms(lambda: K.pass_flags_plain(*args)),
                bytes=8 * H + 4 * (_N_CODES + 12)),
            "advance": dict(
                ms=_time_ms(lambda: K.advance(eq, ob, cnt, W, K.ADV_STEP)),
                graph_ms=_graph_ms(
                    lambda: K.advance(eq, ob, cnt, W, K.ADV_STEP)),
                plain_ms=_time_ms(lambda: K.advance_plain(
                    eq, ob, cnt, W, K.ADV_STEP)),
                bytes=20 * H + 2 * 8 * K.W_LEN)}
        for name, f in fig.items():
            f["bound_ms"] = f["bytes"] / HBM_BYTES_PER_S * 1e3
            rows.append(f"{name}@{H}: {f['ms']:.6f} ms, graph "
                        f"{f['graph_ms']:.6f} (plain {f['plain_ms']:.5f}, "
                        f"bound {f['bound_ms']:.6f})")
            o = out.setdefault(name, {"graph_ms_at": {}})
            o["graph_ms_at"][H] = round(f["graph_ms"], 6)
            o.update(f, max_abs_err=max_err[name], floor_ms=floor_ms,
                     floor_body_ms=floor_body_ms, rows=H)
    for B, H in LANE_SHAPES[::-1]:
        eq, ob, cnt, W = _lane_inputs(K, B, H, B * H)
        G = torch.zeros(K.W_LEN + 1, dtype=torch.int64, device="cuda")

        def kernel():
            K.advance_lanes(eq, ob, cnt, W, G, K.ADV_STEP)
        f = dict(ms=_time_ms(kernel), graph_ms=_graph_ms(kernel),
                 plain_ms=_time_ms(lambda: K.advance_lanes_plain(
                     eq, ob, cnt, W, G, K.ADV_STEP)),
                 bytes=20 * B * H + 2 * 8 * (B * K.W_LEN + 2))
        f["bound_ms"] = f["bytes"] / HBM_BYTES_PER_S * 1e3
        rows.append(f"advance_lanes@{B}x{H}: {f['ms']:.6f} ms, graph "
                    f"{f['graph_ms']:.6f} (plain {f['plain_ms']:.5f}, "
                    f"bound {f['bound_ms']:.6f})")
        o = out.setdefault("advance_lanes", {"graph_ms_at": {}})
        o["graph_ms_at"][f"{B}x{H}"] = round(f["graph_ms"], 6)
        o.update(f, max_abs_err=max_err["advance_lanes"], floor_ms=floor_ms,
                 floor_body_ms=floor_body_ms, rows=f"{B}x{H}")
    # the comparison's launches are not the main path's
    K.LAUNCHES.update(launches0)
    print("  " + "; ".join(rows), flush=True)
    phase("flow-kernels", time.perf_counter() - t0, rows=KERNEL_ROWS[-1],
          **{f"{n}_ms": round(f["ms"], 6) for n, f in out.items()},
          **{f"{n}_graph_ms": round(f["graph_ms"], 6)
             for n, f in out.items()},
          **{f"{n}_plain_ms": round(f["plain_ms"], 5)
             for n, f in out.items()},
          floor_ms=round(floor_ms, 6),
          floor_body_ms=round(floor_body_ms, 6), check_rows=len(CHECK_ROWS),
          lane_checks=len(LANE_CHECK[0]) * len(LANE_CHECK[1]),
          graph_executions=GRAPH_EXECS, bits_equal=True)
    return out


def count_executions(name, rep):
    """Record a card run's kernel executions (the device counters, read
    and zeroed) beside its passes and windows, for the kernels line."""
    from shadow_tpu_torch.core import kernels as K
    ex = K.executions(reset=True)
    CELL_EXECS[name] = {n: {"executions": v,
                            "a_pass": round(v / max(rep.passes, 1), 4),
                            "a_window": round(v / max(rep.windows, 1), 4)}
                        for n, v in ex.items()}
    return ex


def kernels_line(figures, launches, executions, by_path):
    """The contract's kernels line: each kernel's figures from phase 30,
    its launches on its main path (phase 3's run; advance_lanes: phase
    24's batch), the launches on each path counted (`by_path`) and its
    executions on the cells that ran (phases 3, 4, 5 and 24)."""
    what = {"pass_flags": "the drain pass's dispatch bitmap and go-on flag",
            "advance": "the window boundary: next [ws, we), counters",
            "advance_lanes": "the window boundary of stacked scenario "
                             "lanes, a lane frozen when done"}
    return {"kernels": [
        {"name": n, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "none: shadow_tpu has no pl.pallas_call (" + what[n]
                     + " for the captured chunk)",
         "launches": launches[n], "executions": executions.get(n),
         "launches_by_path": {p: c.get(n, 0) for p, c in by_path.items()},
         "max_abs_err": f["max_abs_err"], "ms": round(f["ms"], 6),
         "graph_ms": round(f["graph_ms"], 6),
         "graph_ms_at": f["graph_ms_at"],
         "floor_ms": round(f["floor_ms"], 6),
         "floor_body_ms": round(f["floor_body_ms"], 6),
         "plain_ms": round(f["plain_ms"], 6),
         "bound_ms": round(f["bound_ms"], 6), "bound_by": "bytes",
         "library_ms": None, "rows": f["rows"],
         "cells": {c: e[n] for c, e in CELL_EXECS.items()}}
        for n, f in figures.items()]}


def graph_eager_phase(canonicalize_state):
    """31. phold-4096 (5 sim-s) and the 2-hop lossy SOCKS shape, each on
    the card on the graph path and on the eager path: equal stats,
    windows, digest chains and Hosts fields; and a third run after
    ``Simulation.prewarm``, which captures nothing more and gives the
    same stats and chain."""
    import tempfile

    from shadow_tpu_torch.engine.sim import Simulation
    from shadow_tpu_torch.engine.state import EngineConfig
    t0 = time.perf_counter()
    socks_caps = dict(qcap=32, scap=12, obcap=16, incap=24, txqcap=12,
                      chunk_windows=8)
    n_socks = socks_scenario(0.02, 2, 90).total_hosts()
    with tempfile.TemporaryDirectory() as tmp:
        for name, mk, cfg in (
                ("phold-4096", lambda: phold_scenario(4096, 5),
                 phold_cfg(4096)),
                ("socks-multihop-lossy",
                 lambda: socks_scenario(0.02, 2, 90),
                 EngineConfig(num_hosts=n_socks, **socks_caps))):
            runs = {}
            for graph in (True, False):
                chain = os.path.join(tmp, f"{name}.{graph}.jsonl")
                sim, rep = run(mk(), cfg, "cuda", graph=graph, digest=chain,
                               digest_every=8)
                runs[graph] = (sim, rep, _chain(chain))
            (gs, g, gch), (es, e, ech) = runs[True], runs[False]
            _same_on_both(name, arrays(gs, g), arrays(es, e),
                          canonicalize_state)
            if gch != ech or g.windows != e.windows:
                fail(f"graph=eager {name}: chains or windows differ")
            # a run after Simulation.prewarm replays the graph prewarm
            # captured, with the same results
            chain = os.path.join(tmp, f"{name}.prewarmed.jsonl")
            ps = Simulation(mk(), engine_cfg=cfg, device="cuda")
            info = ps.prewarm(digest_every=8)
            p = ps.run(digest=chain, digest_every=8)
            if not (info["captured"] and p.execution["captures"] == 0
                    and _chain(chain) == gch and (p.stats == g.stats).all()):
                fail(f"graph=eager {name}: the prewarmed run {info} "
                     f"{p.execution} differs from the plain graph run")
            if e.execution["path"] != "eager":
                fail(f"graph=eager {name}: graph=False ran {e.execution}")
            print(f"  {name}: events={g.events} windows={g.windows} "
                  f"passes={g.passes} {graph_str(g, name)} "
                  f"nodes={g.execution['nodes']} graph_wall="
                  f"{g.wall_seconds:.3f}s eager_wall={e.wall_seconds:.3f}s "
                  f"eager_host_reads_per_chunk="
                  f"{e.execution['host_reads_per_chunk']:.1f}", flush=True)
        n_lanes = socks_scenario(0.02, 2, 30).total_hosts()
        for name, mk, cfg, seeds in (
                ("batch-phold-1024x4", lambda: phold_scenario(1024, 5),
                 phold_cfg(1024), (1, 2, 3, 4)),
                ("batch-socks-multihop-lossy-x2",
                 lambda: socks_scenario(0.02, 2, 30),
                 EngineConfig(num_hosts=n_lanes, **socks_caps), (1, 2))):
            _batch_graph_eager(name, mk, cfg, seeds, tmp)
    phase("graph=eager", time.perf_counter() - t0, chains_equal=True)


def _batch_graph_eager(name, mk, cfg, seeds, tmp):
    """A batch of `mk()` lanes (one a seed) on the card's graph path and
    on its eager path (``run_batch(graph=False)``): each lane's digest
    chain, stats, windows and passes equal, and the stacked passes."""
    from shadow_tpu_torch.engine.sim import Simulation
    from shadow_tpu_torch.serving.batch import run_batch
    out = {}
    for graph in (True, False):
        sims = []
        for sd in seeds:
            scen = mk()
            scen.seed = sd
            sims.append(Simulation(scen, engine_cfg=cfg, device="cuda"))
        paths = [os.path.join(tmp, f"{name}.{graph}.{sd}.jsonl")
                 for sd in seeds]
        reps = run_batch(sims, digest_paths=paths, digest_every=8,
                         graph=graph)
        out[graph] = (reps, [_chain(p) for p in paths])
    (g, gch), (e, ech) = out[True], out[False]
    if gch != ech or any(
            not (a.stats == b.stats).all()
            or (a.windows, a.passes, a.batch) != (b.windows, b.passes,
                                                  b.batch)
            for a, b in zip(g, e)):
        fail(f"graph=eager {name}: a lane differs between the paths")
    if e[0].execution["path"] != "eager":
        fail(f"graph=eager {name}: graph=False ran {e[0].execution}")
    fields = " ".join(f"{k}={v}" for k, v in batch_of(g, name).items())
    print(f"  {name}: events={sum(r.events for r in g)} "
          f"lane_windows={[r.windows for r in g]} "
          f"stacked_passes={g[0].batch['stacked_passes']} {fields} "
          f"graph_wall={g[0].wall_seconds:.3f}s "
          f"eager_wall={e[0].wall_seconds:.3f}s eager_host_reads_per_chunk="
          f"{e[0].execution['host_reads_per_chunk']:.1f}", flush=True)


def aot_cache_phase():
    """32. two children on examples/ping.xml: ``--prewarm --aot-cache
    DIR`` builds (or loads) the kernel library and captures the chunk;
    then a run with ``--aot-cache DIR`` builds nothing and loads the
    library from DIR."""
    import tempfile
    t0 = time.perf_counter()
    xml = os.path.join(HERE, "examples", "ping.xml")
    with tempfile.TemporaryDirectory() as d:
        base = [sys.executable, "-m", "shadow_tpu_torch", xml,
                "--aot-cache", d]
        out = []
        for extra in (["--prewarm"], ["--summary-json"]):
            r = subprocess.run(base + extra, capture_output=True, text=True,
                               cwd=HERE, timeout=600)
            if r.returncode:
                fail(f"aot-cache: {' '.join(extra)} exited {r.returncode}:"
                     f" {r.stderr[-2000:]}")
            out.append(json.loads(r.stdout.strip().splitlines()[-1]))
        warm, s = out
        entries = [f for f in os.listdir(d) if f.endswith(".so")]
    if not warm["captured"] or warm["native_cache"] == "none":
        fail(f"aot-cache: the pre-warm captured nothing: {warm}")
    if s["native_builds"] != 0 or s["disk_hits"] < 1 or s["path"] != "graph":
        fail(f"aot-cache: the warm child built {s['native_builds']} "
             f"libraries, loaded {s['disk_hits']}, path {s['path']}")
    phase("aot-cache", time.perf_counter() - t0,
          prewarm_native=warm["native_cache"], warm_builds=0,
          warm_disk_hits=s["disk_hits"], entries=len(entries),
          cache_scope=warm["cache_scope"], mean_rtt_us=s["mean_rtt_us"])


# --- multi-device (parallel/shard.py, parallel/dist.py) ---------------------

MESH_SHARDS = 4
MESH_DIGEST_EVERY = 64
# mesh-tcp-gpu=cpu: phase 11's 2-hop lossy SOCKS shape cut to 30 sim-s,
# with two-slot buckets, so bursts overflow them into ST_DEFER_A2A
MESH_TCP_STOP_S = 30
MESH_TCP_CAPS = dict(qcap=32, scap=12, obcap=16, incap=24, txqcap=12,
                     chunk_windows=8, a2acap=2)


def shard_figures(rep):
    """A mesh run's per-shard passes and events, and their imbalance
    (max over mean; 1.0 is balanced)."""
    from shadow_tpu_torch.engine import defs
    hl = -(-rep.stats.shape[0] // rep.shards)
    ev = rep.stats[:, defs.ST_EVENTS]
    ev_s = [int(ev[i * hl:(i + 1) * hl].sum()) for i in range(rep.shards)]
    ps = rep.shard_passes

    def imb(v):
        return round(max(v) * len(v) / sum(v), 4) if sum(v) else 0.0

    return dict(shard_passes=json.dumps(ps), shard_events=json.dumps(ev_s),
                pass_imbalance=imb(ps), event_imbalance=imb(ev_s))


def _same_runs(name, a, b):
    """Fail unless two reports agree on stats and windows."""
    if a.stats.shape != b.stats.shape or not (a.stats == b.stats).all():
        fail(f"{name}: stats differ from the single run's")
    if a.windows != b.windows:
        fail(f"{name}: {b.windows} windows against {a.windows}")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def mesh_phold_phase(timed, chain, tmp):
    """26. phold-4096 on four shards of the card, prewarmed
    (``Simulation.prewarm(mesh=...)`` captures the sharded chunk, which
    the run replays): the stats, windows and digest chain (every
    MESH_DIGEST_EVERY windows, to `chain`) of an untimed single run,
    whose stats and windows equal phase 3's (`timed`, None when phase 3
    did not run) -> (that single run, the mesh run's kernel launches,
    which must include every kernel of the sharded chunk)."""
    from shadow_tpu_torch.core import kernels as K
    from shadow_tpu_torch.engine.sim import Simulation
    from shadow_tpu_torch.parallel.shard import make_mesh
    _, single = run(phold_scenario(4096, 5), phold_cfg(4096), "cuda",
                    digest=chain, digest_every=MESH_DIGEST_EVERY)
    if timed is not None:
        _same_runs("phold-4096 with a chain", timed, single)
    t0 = time.perf_counter()
    path = os.path.join(tmp, "phold-mesh.jsonl")
    mesh = make_mesh(MESH_SHARDS, "cuda")
    sim = Simulation(phold_scenario(4096, 5), engine_cfg=phold_cfg(4096),
                     device="cuda")
    K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
    info = sim.prewarm(mesh=mesh, digest_every=MESH_DIGEST_EVERY)
    rep = sim.run(mesh=mesh, digest=path, digest_every=MESH_DIGEST_EVERY)
    launches = dict(K.LAUNCHES)
    if rep.shards != MESH_SHARDS or not rep.device.startswith("cuda"):
        fail(f"mesh-phold-4096x4: shards={rep.shards} on {rep.device}")
    if not (info["captured"] and rep.execution["captures"] == 0):
        fail(f"mesh-phold-4096x4: the prewarmed run {info} captured "
             f"again: {rep.execution}")
    if not (launches["pass_flags"] and launches["advance"]):
        fail(f"mesh-phold-4096x4 did not go through its kernels: "
             f"{launches}")
    _same_runs("mesh-phold-4096x4", single, rep)
    records = _read(path).splitlines()
    if records != _read(chain).splitlines():
        fail("mesh-phold-4096x4: digest chain differs from the single "
             "run's")
    phase("mesh-phold-4096x4", time.perf_counter() - t0, **rates(rep),
          single_wall_s=round(single.wall_seconds, 3),
          chain_records=len(records), chains_equal=True,
          cache_scope=info["cache_scope"], launches=json.dumps(launches),
          **graph_of(rep, "mesh-phold-4096x4"), **shard_figures(rep))
    return single, launches


def _single_of(rep):
    """What phases 26, 27 and 29 read of a single run (None: none was
    run), to pass between processes."""
    import types
    return rep and types.SimpleNamespace(stats=rep.stats, windows=rep.windows,
                                         wall_seconds=rep.wall_seconds)


def _mesh_child(conn, phold_timed, chain, gossip_single, tmp):
    """A child process: phases 26 and 27, each run when its single run's
    figures are given (False: not wanted) -> (None, (26's single run,
    the kernel launches of 26's mesh run)), or (the failure, None)."""
    try:
        single = launches = None
        if phold_timed is not False:
            single, launches = mesh_phold_phase(phold_timed, chain, tmp)
            single = _single_of(single)
        if gossip_single is not False:
            mesh_gossip_phase(gossip_single)
        conn.send((None, (single, launches)))
    except BaseException as e:
        conn.send((f"{type(e).__name__}: {e}", None))
        raise


def mesh_gossip_phase(single):
    """27. examples/gossip-100k.xml as written on four shards of the card:
    the plain gossip-100k run's stats and windows. The plain run is run
    again right after, in this process (`single_here_wall_s`): its wall
    beside whatever else shares the card and the host then."""
    from shadow_tpu_torch.parallel.shard import make_mesh
    if single is None:          # --phases without gossip-100k
        _, single = run(gossip_scenario(100_000), gossip_cfg(100_000),
                        "cuda")
    t0 = time.perf_counter()
    _, rep = run(gossip_scenario(100_000), gossip_cfg(100_000), "cuda",
                 mesh=make_mesh(MESH_SHARDS, "cuda"))
    wall = time.perf_counter() - t0
    if rep.shards != MESH_SHARDS or not rep.device.startswith("cuda"):
        fail(f"mesh-gossip-100k: shards={rep.shards} on {rep.device}")
    _same_runs("mesh-gossip-100k", single, rep)
    _, here = run(gossip_scenario(100_000), gossip_cfg(100_000), "cuda")
    _same_runs("mesh-gossip-100k (its plain run again)", single, here)
    phase("mesh-gossip-100k", wall,
          hosts=rep.stats.shape[0], **rates(rep),
          single_wall_s=round(single.wall_seconds, 3),
          single_here_wall_s=round(here.wall_seconds, 3), stats_equal=True,
          **graph_of(rep, "mesh-gossip-100k"), **shard_figures(rep))


def mesh_tcp_run(device, chain, graph=True):
    """mesh-tcp-gpu=cpu's run on `device`: four shards -> (stats, windows,
    summary, shard passes)."""
    from shadow_tpu_torch.engine.state import EngineConfig
    from shadow_tpu_torch.parallel.shard import make_mesh
    scen = socks_scenario(0.02, 2, MESH_TCP_STOP_S)
    cfg = EngineConfig(num_hosts=scen.total_hosts(), **MESH_TCP_CAPS)
    _, rep = run(scen, cfg, device, mesh=make_mesh(MESH_SHARDS, device),
                 digest=chain, digest_every=8, graph=graph)
    return rep.stats, rep.windows, rep.summary(), rep.shard_passes


def _mesh_tcp_cpu_child(conn, chain):
    """A child process: mesh-tcp-gpu=cpu's CPU half -> (None, run), or
    the failure."""
    try:
        torch.set_num_threads(2)
        conn.send((None, mesh_tcp_run("cpu", chain)))
    except BaseException as e:
        conn.send((f"{type(e).__name__}: {e}", None))
        raise


def mesh_tcp_phase(child, tmp):
    """28. a lossy 2-hop SOCKS shape on four shards with two-slot
    buckets: bursts defer into ST_DEFER_A2A, and the card's mesh on the
    graph path gives the card's eager path's (graph=False) and the CPU
    mesh's stats, windows, passes a shard and digest chain."""
    t0 = time.perf_counter()
    path = os.path.join(tmp, "mesh-tcp-cuda.jsonl")
    gst, gwin, s, ps = mesh_tcp_run("cuda", path)
    graph_fields = graph_summary(s, "mesh-tcp-gpu=cpu")
    epath = os.path.join(tmp, "mesh-tcp-eager.jsonl")
    est, ewin, es, eps = mesh_tcp_run("cuda", epath, graph=False)
    if (not (gst == est).all() or (gwin, ps) != (ewin, eps)
            or _read(path) != _read(epath)):
        fail("mesh-tcp-gpu=cpu: the card's graph and eager paths differ")
    (err, cpu), waited = child.result()
    if err:
        fail(f"mesh-tcp-gpu=cpu (cpu): {err}")
    cst, cwin, cs, cps = cpu
    if not (gst == cst).all() or (gwin, ps) != (cwin, cps):
        fail("mesh-tcp-gpu=cpu: stats, windows or passes differ between "
             "cuda and cpu")
    if _read(path) != _read(os.path.join(tmp, "mesh-tcp-cpu.jsonl")):
        fail("mesh-tcp-gpu=cpu: digest chains differ between cuda and cpu")
    if not (s["defer_a2a"] > 0 and s["transfers_done"] and
            s["retransmits"]):
        fail(f"mesh-tcp-gpu=cpu: no bucket overflow, transfer or loss "
             f"recovery: {s}")
    phase("mesh-tcp-gpu=cpu", time.perf_counter() - t0,
          waited_s=round(waited, 3), events=s["events"], windows=gwin,
          defer_a2a=s["defer_a2a"], transfers=s["transfers_done"],
          retransmits=s["retransmits"], cuda_wall=round(s["wall_seconds"],
                                                        3),
          cpu_wall=round(cs["wall_seconds"], 3),
          eager_wall=round(es["wall_seconds"], 3),
          eager_host_reads_per_chunk=es["host_reads_per_chunk"],
          shard_passes=json.dumps(ps), graph=graph_fields,
          chains_equal=True)


def _dist_phold_child(conn, coordinator, rank, backend, chain):
    """One rank of dist-phold: phold-4096 on two shards of a four-shard
    mesh over ``parallel.dist`` on the card -> (None, figures), rank 0
    with the stats, or the failure."""
    from shadow_tpu_torch.parallel import dist
    try:
        t0 = time.perf_counter()
        dist.init(coordinator, 2, rank, local_shards=2, backend=backend,
                  device="cuda")
        mesh = dist.global_mesh()
        _, rep = run(phold_scenario(4096, 5), phold_cfg(4096), "cuda",
                     mesh=mesh, digest=chain,
                     digest_every=MESH_DIGEST_EVERY)
        out = dict(rank=rank, backend=rep.mesh["backend"],
                   shards=rep.shards, device=rep.device,
                   windows=rep.windows, events=rep.events,
                   run_wall_s=round(rep.wall_seconds, 3),
                   staged_bytes=rep.mesh["host_staged_bytes"],
                   shard_passes=rep.shard_passes,
                   wall=time.perf_counter() - t0)
        if rank == 0:
            out["stats"] = rep.stats
        dist.shutdown()
        conn.send((None, out))
    except BaseException as e:
        conn.send((f"{type(e).__name__}: {e}", None))
        raise


def dist_phold_start(tmp):
    """29. dist-phold's two ranks, each a process of its own on the card
    (gloo with fewer than two cards: NCCL refuses two ranks on one)."""
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    chain = os.path.join(tmp, "phold-dist.jsonl")
    return [Child(_dist_phold_child, f"dist-phold rank {r}",
                  args=(f"127.0.0.1:{port}", r, backend, chain))
            for r in range(2)], chain


def dist_phold_finish(ranks, chain, single, single_chain):
    """29. dist-phold: the ranks' stats and chain equal phase 26's
    untimed single run and its chain (run here when 26 did not)."""
    outs = []
    for child in ranks:
        (err, out), _ = child.result()
        if err:
            fail(f"{child.name}: {err}")
        outs.append(out)
    if single is None:
        _, single = run(phold_scenario(4096, 5), phold_cfg(4096), "cuda",
                        digest=single_chain,
                        digest_every=MESH_DIGEST_EVERY)
    r0 = outs[0]
    if r0["shards"] != MESH_SHARDS or not r0["device"].startswith("cuda"):
        fail(f"dist-phold: shards={r0['shards']} on {r0['device']}")
    if not (r0["stats"] == single.stats).all() or \
            r0["windows"] != single.windows:
        fail("dist-phold: stats or windows differ from the single run's")
    if _read(chain) != _read(single_chain):
        fail("dist-phold: digest chain differs from the single run's")
    phase("dist-phold", max(o["wall"] for o in outs),
          backend=r0["backend"], processes=2, shards=r0["shards"],
          windows=r0["windows"], events=r0["events"],
          run_wall_s=json.dumps([o["run_wall_s"] for o in outs]),
          shard_passes=json.dumps(r0["shard_passes"]),
          host_staged_bytes=json.dumps([o["staged_bytes"] for o in outs]),
          chains_equal=True)


def arrays(sim, rep):
    """A finished run -> (stats, Hosts arrays)."""
    return rep.stats, sim.final_hosts.numpy()


def _same_on_both(name, grun, crun, canonicalize_state):
    """Fail unless two finished runs (cuda, cpu), each (stats, Hosts
    arrays), agree on stats and on every canonicalized Hosts field ->
    the raw-differing field names."""
    (gst, ga), (cst, ca) = grun, crun
    if not (gst == cst).all():
        fail(f"{name}: stats differ between cuda and cpu")
    raw = [f for f in ga if not (ga[f] == ca[f]).all()]
    ga, ca = canonicalize_state(ga), canonicalize_state(ca)
    bad = [f for f in ga if ga[f].dtype != ca[f].dtype
           or not (ga[f] == ca[f]).all()]
    if bad:
        fail(f"{name}: Hosts fields differ between cuda and cpu: {bad}")
    return raw


def udp_gpu_cpu_phase(canonicalize_state):
    """9. the card and the CPU agree bit for bit."""
    t0 = time.perf_counter()
    for name, mk, cfg in (
            ("phold-256-lossy", lambda: phold_scenario(256, 5, loss=0.02,
                                                       mean="150ms"),
             phold_cfg(256)),
            ("gossip-1000", lambda: gossip_scenario(1000, 15),
             gossip_cfg(1000))):
        g, grep = run(mk(), cfg, "cuda")
        c, crep = run(mk(), cfg, "cpu")
        raw = _same_on_both(name, arrays(g, grep), arrays(c, crep),
                            canonicalize_state)
        if name.startswith("phold") and not grep.summary()["drop_net"]:
            fail(f"{name}: no packet was lost on the lossy edge")
        print(f"  {name}: events={grep.events} cuda_wall="
              f"{grep.wall_seconds:.3f}s cpu_wall={crep.wall_seconds:.3f}s "
              f"fields_equal=82 raw_differing={raw} "
              f"{graph_str(grep, name)}", flush=True)
    phase("gpu=cpu", time.perf_counter() - t0)


def cbrt_phase():
    """10. the float32 cbrt of the cubic: the card gives the CPU's bits."""
    from shadow_tpu_torch.net.congestion import cbrt_f32
    t0 = time.perf_counter()
    x = cbrt_inputs()
    cpu_bits = torch.cat([cbrt_f32(v) for v in x.split(1 << 20)]
                         ).view(torch.int32)
    gpu_bits = cbrt_f32(x.cuda()).view(torch.int32).cpu()
    same = (cpu_bits == gpu_bits) | (torch.isnan(x) & torch.isnan(
        gpu_bits.view(torch.float32)) & torch.isnan(cpu_bits.view(
            torch.float32)))
    diff = int((~same).sum())
    if diff:
        fail(f"cbrt_f32 cuda != cpu on {diff} of {x.numel()} inputs")
    phase("cbrt", time.perf_counter() - t0, inputs=x.numel(), mismatches=0)


def socks10k_phase(defs):
    """5. socks10k through Simulation on the card, on the graph path,
    then the replays of one of its chunks (``ChunkSpan``)."""
    from shadow_tpu_torch.core import kernels as K
    t0 = time.perf_counter()
    sim = socks10k_sim()
    span = ChunkSpan(SOCKS_SPAN_NS)
    K.executions(reset=True)
    with span.attached():
        rep = sim.run()
    count_executions("socks10k", rep)
    s = rep.summary()
    st = rep.stats
    from shadow_tpu_torch.apps.base import APP_SOCKS_CLIENT
    clients = st[(sim.hp.app_kind[:, 0] == APP_SOCKS_CLIENT).cpu().numpy()]
    done_share = float((clients[:, defs.ST_XFER_DONE] > 0).mean())
    sock_fail = st[:, defs.ST_SOCK_FAIL]
    chain_short = st[:, defs.ST_CHAIN_SHORT]
    if s["transfers_done"] <= 0 or done_share <= 0:
        fail(f"socks10k: no client completed a fetch: {s}")
    if s["drop_q"] != 0:
        fail(f"socks10k: event-queue drops {s['drop_q']} (engine fault)")
    print(f"  socks10k run: {json.dumps(rates(rep) | s)}", flush=True)
    wall = time.perf_counter() - t0
    graph = graph_of(rep, "socks10k")
    span = span.report()
    phase("socks10k", wall, **rates(rep),
          stop_sim_s=SOCKS_STOP_S, **graph,
          span=json.dumps(span, separators=(",", ":")),
          bytes_recv=s["bytes_recv"], transfers_done=s["transfers_done"],
          retransmits=s["retransmits"], clients_done_share=round(
              done_share, 6),
          sock_fail_sum=int(sock_fail.sum()),
          sock_fail_hosts=int((sock_fail > 0).sum()),
          chain_short_sum=int(chain_short.sum()),
          chain_short_hosts=int((chain_short > 0).sum()),
          drop_net=s["drop_net"], defer_fanin=s["defer_fanin"])
    return sim, rep


def tcp_gpu_cpu_phase(canonicalize_state):
    """11. TCP on the card and on the CPU, bit for bit."""
    from shadow_tpu_torch.engine.state import EngineConfig
    t0 = time.perf_counter()
    for name, mk, caps in (
            ("bulk-lossy", lambda: bulk_scenario(0.05, 120_000, 2),
             dict(qcap=16, scap=4, obcap=8, incap=16, txqcap=8,
                  chunk_windows=8)),
            ("socks-multihop-lossy", lambda: socks_scenario(0.02, 2, 90),
             dict(qcap=32, scap=12, obcap=16, incap=24, txqcap=12,
                  chunk_windows=8))):
        n = mk().total_hosts()
        g = run(mk(), EngineConfig(num_hosts=n, **caps), "cuda")
        c = run(mk(), EngineConfig(num_hosts=n, **caps), "cpu")
        raw = _same_on_both(name, arrays(*g), arrays(*c),
                            canonicalize_state)
        s = g[1].summary()
        if not s["retransmits"] or not s["transfers_done"]:
            fail(f"{name}: no loss recovery or no transfer: {s}")
        print(f"  {name}: events={s['events']} retransmits="
              f"{s['retransmits']} transfers={s['transfers_done']} "
              f"cuda_wall={g[1].wall_seconds:.3f}s cpu_wall="
              f"{c[1].wall_seconds:.3f}s fields_equal=82 "
              f"raw_differing={raw} {graph_str(g[1], name)}", flush=True)
    phase("tcp-gpu=cpu", time.perf_counter() - t0)


def cli_tcp_phase(cli):
    """12. bulk and SOCKS XML through the CLI, on the card by default."""
    import tempfile
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, scen in (("bulk", bulk_scenario(0.05, 120_000, 2)),
                           ("socks", socks_scenario(0.02, 2, 90))):
            path = os.path.join(tmp, f"{name}.xml")
            with open(path, "w") as f:
                f.write(scen.to_xml())
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli([path, "--runahead", "10ms", "--summary-json"])
            s = json.loads(buf.getvalue().strip().splitlines()[-1])
            if rc != 0 or s["device"] != "cuda" or not s["transfers_done"]:
                fail(f"cli {name}: rc={rc} {s}")
            out[name] = (s["events"], s["transfers_done"], s["windows"])
    phase("cli-tcp", time.perf_counter() - t0,
          **{f"{k}_events_xfers_windows": v for k, v in out.items()})


def tgen1k_phase(defs):
    """6. tgen-1k through Simulation on the card, on the graph path,
    then the replays of one of its chunks (``ChunkSpan``)."""
    from shadow_tpu_torch.baseline_configs import bulk1k
    t0 = time.perf_counter()
    sim = bulk1k(1000, stop=TGEN_STOP_S, device="cuda", runahead_ms=10)
    span = ChunkSpan(TGEN_SPAN_NS)
    with span.attached():
        rep = sim.run()
    s = rep.summary()
    st = rep.stats
    kind = {k: np.array([n.startswith(k) for n in sim.host_names])
            for k in ("server", "web", "bulk")}
    xfer = st[:, defs.ST_XFER_DONE]
    gets, puts = int(xfer[kind["web"]].sum()), int(xfer[kind["bulk"]].sum())
    out = dict(
        rates(rep), events_per_pass=round(s["events"] / max(s["passes"], 1),
                                          3),
        stop_sim_s=TGEN_STOP_S, gets_done=gets, puts_done=puts,
        puts_received=int(xfer[kind["server"]].sum()),
        web_done_share=round(float((xfer[kind["web"]] > 0).mean()), 6),
        bulk_done_share=round(float((xfer[kind["bulk"]] > 0).mean()), 6),
        tgen_drop=int(st[:, defs.ST_TGEN_DROP].sum()),
        tgen_abort=int(st[:, defs.ST_TGEN_ABORT].sum()),
        drop_q=s["drop_q"], sock_fail=int(st[:, defs.ST_SOCK_FAIL].sum()),
        retransmits=s["retransmits"], drop_buf=s["drop_buf"],
        defer_fanin=s["defer_fanin"])
    print(f"  tgen-1k run: {json.dumps(out)}", flush=True)
    if out["drop_q"] or out["sock_fail"] or out["tgen_drop"]:
        fail(f"tgen-1k: event-queue drops, socket-table failures or lost "
             f"walk branches: {out}")
    if not (gets and puts):
        fail(f"tgen-1k: GETs or PUTs never completed: {out}")
    wall = time.perf_counter() - t0
    graph = graph_of(rep, "tgen-1k")
    span = span.report()
    phase("tgen-1k", wall, **out, **graph,
          span=json.dumps(span, separators=(",", ":")))


# tgen-gpu=cpu's shapes (the default run) and tgen-1k-cpu's
TGEN_GPU_CPU = ("tgen-web-lossy", "tgen-fork-sync", "tgen-server+bulk",
                "tgen-1k-at-50")


def _tgen_shapes():
    """name -> (scenario maker, engine config of the host count or None
    for the automatic one, runahead ms)."""
    from shadow_tpu_torch.baseline_configs import (_tgen_client_graph,
                                                   build_bulk_1k,
                                                   socks_caps)
    from shadow_tpu_torch.engine.state import EngineConfig

    def caps(**kw):
        return lambda n: EngineConfig(num_hosts=n, **kw)

    # tests/test_tgen.py's web client: GET 50 KiB, pause 1 or 2 s, 3 rounds
    web = _tgen_client_graph("server1:30080,server2:30080", "get", "50 KiB",
                             "1,2", 3)
    return {
        # tests/test_differential.py::test_differential_tgen_web
        "tgen-web-lossy": (lambda: tgen_scenario(web, 2, 2, 40, 0.03),
                           caps(qcap=24, scap=6, obcap=12, incap=16,
                                txqcap=8, chunk_windows=8), 0),
        # tests/test_tgen.py::test_tgen_fork_and_synchronize
        "tgen-fork-sync": (lambda: tgen_scenario(fork_graph(), 2, 2, 60),
                           lambda n: None, 0),
        # tests/test_multiproc.py::test_tgen_server_plus_bulk_client
        "tgen-server+bulk": (combo_scenario,
                             caps(qcap=32, scap=12, obcap=16, incap=24,
                                  txqcap=12, chunk_windows=8), 0),
        # tgen-1k at 50 hosts, 3 sim-s (4 sim-s took 235.0 s on the
        # card; the time pays for socks10k-faults)
        "tgen-1k-at-50": (lambda: build_bulk_1k(50, stop=3),
                          lambda n: socks_caps(n, scap=32), 10),
        # tgen-1k, all 1,000 hosts, to 2.25 sim-s (6,205 passes; the CPU
        # half takes ~70 ms a pass)
        "tgen-1k-2.25": (lambda: build_bulk_1k(1000, stop=2.25),
                         lambda n: socks_caps(n, scap=32), 10),
    }


def _tgen_run(name, device):
    """Run one tgen shape -> (stats, Hosts arrays, summary)."""
    from shadow_tpu_torch.baseline_configs import apply_runahead
    from shadow_tpu_torch.engine.sim import Simulation
    mk, cfg, runahead = _tgen_shapes()[name]
    scen = mk()
    sim = apply_runahead(Simulation(scen, engine_cfg=cfg(
        scen.total_hosts()), device=device), runahead)
    rep = sim.run()
    return *arrays(sim, rep), rep.summary()


def _tgen_cpu_run(name):
    """A child process's CPU half of one tgen shape."""
    torch.set_num_threads(4)
    return _tgen_run(name, "cpu")


def tgen_gpu_cpu_phase(canonicalize_state, label="tgen-gpu=cpu",
                       names=TGEN_GPU_CPU):
    """13. tgen and multi-process hosts on the card and on the CPU, bit
    for bit. The CPU halves run in a child process while the card runs
    (results only: neither side's wall is a measurement here)."""
    import concurrent.futures as cf
    import multiprocessing as mp
    t0 = time.perf_counter()
    with cf.ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as ex:
        cpu = {n: ex.submit(_tgen_cpu_run, n) for n in names}
        for name in names:
            gst, ga, s = _tgen_run(name, "cuda")
            cst, ca, cs = cpu[name].result()
            raw = _same_on_both(name, (gst, ga), (cst, ca),
                                canonicalize_state)
            if s["windows"] != cs["windows"]:
                fail(f"{name}: {s['windows']} windows on cuda, "
                     f"{cs['windows']} on cpu")
            if not s["transfers_done"]:
                fail(f"{name}: no transfer completed: {s}")
            print(f"  {name}: events={s['events']} passes={s['passes']} "
                  f"windows={s['windows']} transfers={s['transfers_done']} "
                  f"retransmits={s['retransmits']} cuda_wall="
                  f"{s['wall_seconds']:.3f}s cpu_wall="
                  f"{cs['wall_seconds']:.3f}s fields_equal=82 "
                  f"raw_differing={raw} {graph_summary(s, name)}",
                  flush=True)
    phase(label, time.perf_counter() - t0)


def tgen1k_cpu_phase(canonicalize_state):
    """tgen-1k-cpu: tgen-1k to 2.25 sim-s on the card and on the CPU, bit
    for bit (the stats hold every host's transfers)."""
    tgen_gpu_cpu_phase(canonicalize_state, "tgen-1k-cpu", ("tgen-1k-2.25",))


def _chain(path):
    with open(path, "rb") as f:
        return f.read()


def _snapshots(base):
    """[(path, window start ns, windows, fault schedule position)] of the
    store at `base`, oldest first."""
    from shadow_tpu_torch.engine.checkpoint import CheckpointStore
    out = []
    for path in sorted(CheckpointStore(base).snapshots()):
        with np.load(path) as z:
            out.append((path, int(z["__wstart__"]), int(z["__windows__"]),
                        int(z["__fault_idx__"])))
    return out


def _snapshot_inside(base, injector, t_in, t_out):
    """The newest snapshot taken while the fault episode [t_in, t_out)
    was on: every fault up to t_in applied, none from t_out."""
    lo = sum(ev.t <= t_in for ev in injector.events)
    hi = sum(ev.t < t_out for ev in injector.events)
    inside = [s for s in _snapshots(base) if lo <= s[3] <= hi]
    if not inside:
        fail(f"no snapshot of {base} lies inside the fault episode "
             f"[{t_in}, {t_out}) ns: {_snapshots(base)}")
    return inside[-1]


def faults_demo_phase(cli):
    """14. examples/faults-demo.xml through the CLI, card and CPU."""
    import tempfile
    t0 = time.perf_counter()
    xml = os.path.join(HERE, "examples", "faults-demo.xml")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cuda", "cpu"):
            chain = os.path.join(tmp, f"{dev}.jsonl")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli([xml, "--summary-json", "--digest", chain,
                          "--device", dev])
            s = json.loads(buf.getvalue().strip().splitlines()[-1])
            out[dev] = (rc, s, _chain(chain))
    (rc, s, gch), (crc, cs, cch) = out["cuda"], out["cpu"]
    if rc or crc or s["device"] != "cuda":
        fail(f"faults-demo: rc={rc}/{crc} {s}")
    if (s["path"], s["host_reads_per_chunk"]) != ("graph", 1.0):
        fail(f"faults-demo: the card's run took the {s['path']} path, "
             f"{s['host_reads_per_chunk']} host reads a chunk")
    if gch != cch:
        fail("faults-demo: the card's digest chain differs from the CPU's")
    # pings at 2, 3, 6, 8 and 9 s answered; 4 and 5 s lost on the link
    if (s["faults_applied"], s["drop_net"], s["transfers_done"]) != (4, 2, 5):
        fail(f"faults-demo: unexpected fault effects: {s}")
    phase("faults-demo", time.perf_counter() - t0, events=s["events"],
          faults_applied=4, drop_net=2, pings_answered=5,
          chain_records=gch.count(b"\n"), chains_equal=True, path="graph",
          captures=s["captures"], replays=s["replays"],
          host_reads_per_chunk=s["host_reads_per_chunk"])


def ckpt_socks_scenario():
    """Phase 11's multihop lossy SOCKS with relay1 down over
    [2.2 s, 5.2 s), mid-transfer (its two RSTs free peers)."""
    from shadow_tpu_torch.core.config import FaultSpec
    scen = socks_scenario(0.02, 2, 90)
    scen.faults = [FaultSpec(kind="host_down", at=2200 * 10**6,
                             until=5200 * 10**6, host="relay1")]
    return scen


def ckpt_gpu_cpu_phase():
    """15. checkpointed on the card, resumed on the CPU."""
    import shutil
    import tempfile

    from shadow_tpu_torch.engine.sim import Simulation
    from shadow_tpu_torch.engine.state import EngineConfig
    t0 = time.perf_counter()
    cfg = EngineConfig(num_hosts=8, qcap=32, scap=12, obcap=16, incap=24,
                       txqcap=12, chunk_windows=8)
    with tempfile.TemporaryDirectory() as tmp:
        g, c, r = (os.path.join(tmp, f"{n}.jsonl") for n in "gcr")
        base = os.path.join(tmp, "ck")
        grep = Simulation(ckpt_socks_scenario(), engine_cfg=cfg,
                          device="cuda").run(
            digest=g, digest_every=8, checkpoint_path=base,
            checkpoint_every_s=0.5, checkpoint_keep=50)
        crep = Simulation(ckpt_socks_scenario(), engine_cfg=cfg,
                          device="cpu").run(digest=c, digest_every=8)
        snap = _snapshot_inside(base, Simulation(
            ckpt_socks_scenario(), engine_cfg=cfg, device="cpu").injector,
            2200 * 10**6, 5200 * 10**6)[0]
        shutil.copy(g, r)
        rrep = Simulation(ckpt_socks_scenario(), engine_cfg=cfg,
                          device="cpu").run(digest=r, digest_every=8,
                                            resume_from=snap)
        if not (_chain(g) == _chain(c) == _chain(r)):
            fail("ckpt-gpu=cpu: the resumed CPU chain, the uninterrupted "
                 "CPU chain and the card's differ")
        if not ((grep.stats == crep.stats).all()
                and (rrep.stats == crep.stats).all()):
            fail("ckpt-gpu=cpu: final stats differ")
        if not grep.durability["rsts"] or not grep.summary()[
                "transfers_done"]:
            fail(f"ckpt-gpu=cpu: no RST or no transfer: "
                 f"{grep.durability} {grep.summary()}")
        with np.load(snap) as z:
            snap_ns = int(z["__wstart__"])
        phase("ckpt-gpu=cpu", time.perf_counter() - t0,
              events=grep.events, windows=grep.windows,
              rsts=grep.durability["rsts"],
              transfers=grep.summary()["transfers_done"],
              snapshot_sim_ns=snap_ns, chain_records=_chain(g).count(b"\n"),
              chains_equal=True, **graph_of(grep, "ckpt-gpu=cpu"))


def cpu_model_gpu_cpu_phase():
    """16. tests/test_cpu_model.py's blocked-threshold shape: a 1 ms
    cost per server event (30 MHz against the 3 GHz raw frequency) and
    a 1 us threshold."""
    import tempfile

    from shadow_tpu_torch.core.config import HostSpec, ProcessSpec, Scenario
    from shadow_tpu_torch.engine.sim import Simulation
    from shadow_tpu_torch.engine.state import EngineConfig
    t0 = time.perf_counter()

    def scen():
        s = Scenario(
            stop_time=6 * 10**9,
            topology_graphml=poi_topology(bw_down=10240, latency_ms=25.0),
            hosts=[
                HostSpec(id="srv", cpu_frequency=30_000, processes=[
                    ProcessSpec(plugin="pingserver", start_time=10**9,
                                arguments="port=8000")]),
                HostSpec(id="cli", processes=[
                    ProcessSpec(plugin="ping", start_time=2 * 10**9,
                                arguments="peer=srv port=8000 "
                                          "interval=500ms size=64 "
                                          "count=5")])])
        s.cpu_threshold_ns = 1000
        s.cpu_precision_ns = 1000
        return s

    cfg = EngineConfig(num_hosts=2, qcap=16, scap=4, obcap=8, incap=16,
                       chunk_windows=8)
    reps = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cuda", "cpu"):
            sim = Simulation(scen(), engine_cfg=cfg, device=dev)
            chain = os.path.join(tmp, f"{dev}.jsonl")
            reps[dev] = (sim, sim.run(digest=chain, digest_every=1),
                         _chain(chain))
    (gsim, g, gch), (_, c, cch) = reps["cuda"], reps["cpu"]
    s = g.summary()
    if not gsim.cfg.cpu_model or gch != cch or not (g.stats == c.stats).all():
        fail("cpu-model-gpu=cpu: the card and the CPU differ")
    if s["transfers_done"] != 5 or s["mean_rtt_us"] <= 50_000:
        fail(f"cpu-model-gpu=cpu: the CPU model did not delay: {s}")
    phase("cpu-model-gpu=cpu", time.perf_counter() - t0,
          events=s["events"], mean_rtt_us=s["mean_rtt_us"],
          chain_records=gch.count(b"\n"), chains_equal=True,
          **graph_of(g, "cpu-model-gpu=cpu"))


# examples/gossip-100k.xml's own cap overrides (its comment)
GOSSIP_CAPS = "qcap=16,scap=2,obcap=16,incap=32,chunk=256"
# heartbeat columns that measure the process rather than the simulation
_MEASURED = None


def _norm_heartbeats(lines):
    """Heartbeat lines minus dev=, dev-peak-gib=, waste= and the
    getrusage columns (they depend on where the run executes)."""
    import re
    global _MEASURED
    if _MEASURED is None:
        _MEASURED = re.compile(r",dev=\d+|dev-peak-gib=[^,]*,|waste=[^,]*,|"
                               r"maxrss-gib=.*$")
    return [_MEASURED.sub("", line) for line in lines]


def gossip_telemetry_phase(plain):
    """18. gossip-100k through ``python -m shadow_tpu_torch`` with every
    telemetry flag on: the same stats as phase 4 (`plain`, its report,
    when it ran), an RTT histogram as large as ST_RTT_COUNT, one [node]
    line per host in each heartbeat emission, metrics.json with sim and
    net, >= 90% of the wall attributed (or the residual named) and a
    cuda ledger entry."""
    import collections
    import re
    import tempfile

    from shadow_tpu_torch.__main__ import main as cli
    from shadow_tpu_torch.engine import defs
    from shadow_tpu_torch.engine import sim as S
    from shadow_tpu_torch.obs import ledger as LG
    t0 = time.perf_counter()
    reports = []
    run = S.Simulation.run

    def keep(self, *a, **kw):
        reports.append(run(self, *a, **kw))
        return reports[-1]

    with tempfile.TemporaryDirectory() as tmp:
        def p(name):
            return os.path.join(tmp, name)

        S.Simulation.run = keep
        try:
            with open(p("run.log"), "w") as log, \
                    contextlib.redirect_stdout(log):
                rc = cli([os.path.join(HERE, "examples", "gossip-100k.xml"),
                          "--engine-caps", GOSSIP_CAPS, "--summary-json",
                          "--netscope", p("ns.jsonl"),
                          "--metrics", p("metrics.json"),
                          "--trace", p("trace.json"),
                          "--perf", p("ledger.jsonl"),
                          "--heartbeat-frequency", "10"])
        finally:
            S.Simulation.run = run
        rep = reports[-1]
        text = open(p("run.log")).read().splitlines()
        snap = json.load(open(p("metrics.json")))
        ledger = LG.read(p("ledger.jsonl"))
        ns_records = sum(1 for _ in open(p("ns.jsonl"))) - 1
    s = json.loads(text[-1])
    if rc != 0 or s["device"] != "cuda":
        fail(f"gossip-100k-telemetry: rc={rc} {s}")
    if plain is not None and not (rep.stats == plain.stats).all():
        fail("gossip-100k-telemetry: stats differ from gossip-100k's")
    rtt = rep.network["kinds"]["rtt"]["count"]
    if rtt != rep.total(defs.ST_RTT_COUNT):
        fail(f"gossip-100k-telemetry: {rtt} RTT samples against "
             f"{rep.total(defs.ST_RTT_COUNT)} ST_RTT_COUNT")
    nodes = collections.Counter(
        x.split("[node] ")[1].split(",")[0] for x in text if "] [node] " in x)
    emissions = sum("] [summary] " in x for x in text)
    H = len(rep.host_names)
    if not emissions or len(nodes) != emissions or set(
            nodes.values()) != {H}:
        fail(f"gossip-100k-telemetry: {emissions} heartbeat emissions "
             f"with [node] lines per emission {dict(nodes)}")
    if "sim" not in snap or "net" not in snap:
        fail(f"gossip-100k-telemetry: metrics.json sections {sorted(snap)}")
    m = re.search(r"\(([\d.]+)% of [\d.]+s wall attributed\)",
                  "\n".join(text))
    attributed = float(m.group(1)) if m else 0.0
    residual = next((x for x in text if x.startswith("residual")), None)
    if attributed < 90.0 and residual is None:
        fail(f"gossip-100k-telemetry: {attributed}% attributed and no "
             "residual named")
    if len(ledger) != 1 or ledger[0]["platform"] != "cuda":
        fail(f"gossip-100k-telemetry: ledger {ledger}")
    perf = snap.get("perf", {})
    phase("gossip-100k-telemetry", time.perf_counter() - t0, **rates(rep),
          plain_wall_s=(round(plain.wall_seconds, 3)
                        if plain is not None else None),
          stats_equal=plain is not None, rtt_samples=rtt,
          rtt_p50_us=s["rtt_p50_us"], rtt_p99_us=s["rtt_p99_us"],
          emissions=emissions, node_lines_per_emission=H,
          log_lines=len(text), netscope_records=ns_records,
          attributed_pct=attributed,
          tracker_s=perf.get("phase.tracker_s"),
          netscope_s=perf.get("phase.netscope_s"),
          window_s=perf.get("phase.window_s"),
          mem_peak_bytes=s.get("mem_peak_bytes"),
          ledger_platform=ledger[0]["platform"])
    if residual:
        print(f"  {residual}", flush=True)


def _telemetry_shapes():
    """name -> (scenario maker, engine caps): phase 11's lossy bulk and
    2-hop lossy SOCKS with netscope on and logpcap on two hosts."""
    def bulk():
        s = bulk_scenario(0.05, 120_000, 2)
        for h in s.hosts:
            h.pcap = True
        return s

    def socks():
        s = socks_scenario(0.02, 2, 90)
        s.hosts[0].pcap = True          # the two target servers
        return s

    return {
        "bulk-lossy": (bulk, dict(qcap=16, scap=4, obcap=8, incap=16,
                                  txqcap=8, chunk_windows=8,
                                  netscope=True)),
        "socks-multihop-lossy": (socks, dict(
            qcap=32, scap=12, obcap=16, incap=24, txqcap=12,
            chunk_windows=8, netscope=True)),
    }


def _telemetry_run(name, device):
    """One telemetry shape with netscope, pcap and heartbeats -> (stats,
    Hosts arrays, summary, netscope bytes, {pcap file: bytes},
    normalized heartbeat lines)."""
    import tempfile

    from shadow_tpu_torch.engine.sim import Simulation
    from shadow_tpu_torch.engine.state import EngineConfig
    from shadow_tpu_torch.obs.logger import SimLogger
    mk, caps = _telemetry_shapes()[name]
    scen = mk()
    sim = Simulation(scen, engine_cfg=EngineConfig(
        num_hosts=scen.total_hosts(), **caps), device=device)
    with tempfile.TemporaryDirectory() as tmp:
        ns = os.path.join(tmp, "ns.jsonl")
        pdir = os.path.join(tmp, "pcap")
        rep = sim.run(netscope=ns, pcap_dir=pdir, heartbeat_s=1.0,
                      logger=SimLogger(stream=io.StringIO()))
        ns_bytes = open(ns, "rb").read()
        pcaps = {f: open(os.path.join(pdir, f), "rb").read()
                 for f in sorted(os.listdir(pdir))}
    return (*arrays(sim, rep), rep.summary(), ns_bytes, pcaps,
            _norm_heartbeats(rep.heartbeats))


def _telemetry_cpu_run(name):
    """A child process's CPU half of one telemetry shape."""
    torch.set_num_threads(4)
    return _telemetry_run(name, "cpu")


def telemetry_gpu_cpu_phase(canonicalize_state):
    """19. telemetry on the card and on the CPU, bit for bit: stats,
    Hosts fields, netscope JSONL bytes, pcap bytes and heartbeat lines
    (apart from the columns that measure the process). The CPU halves
    run in a child process while the card runs."""
    import concurrent.futures as cf
    import multiprocessing as mp
    t0 = time.perf_counter()
    names = tuple(_telemetry_shapes())
    with cf.ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as ex:
        cpu = {n: ex.submit(_telemetry_cpu_run, n) for n in names}
        for name in names:
            gst, ga, s, gns, gpc, ghb = _telemetry_run(name, "cuda")
            cst, ca, cs, cns, cpc, chb = cpu[name].result()
            _same_on_both(name, (gst, ga), (cst, ca), canonicalize_state)
            if gns != cns:
                fail(f"{name}: netscope streams differ")
            if gpc != cpc or len(gpc) != 2:
                fail(f"{name}: pcap files differ: {sorted(gpc)} "
                     f"{sorted(cpc)}")
            if ghb != chb or not ghb:
                fail(f"{name}: heartbeat lines differ")
            if not (s["retransmits"] and s["transfers_done"]
                    and s["completion_p99_s"] and ga["tr_drop"].sum() == 0):
                fail(f"{name}: {s}")
            print(f"  {name}: events={s['events']} "
                  f"netscope_bytes={len(gns)} pcap_bytes="
                  f"{[len(b) for b in gpc.values()]} heartbeat_lines="
                  f"{len(ghb)} rtt_p50_us={s['rtt_p50_us']} "
                  f"completion_p99_s={s['completion_p99_s']} "
                  f"cuda_wall={s['wall_seconds']:.3f}s cpu_wall="
                  f"{cs['wall_seconds']:.3f}s {graph_summary(s, name)}",
                  flush=True)
    phase("telemetry-gpu=cpu", time.perf_counter() - t0)


# socks10k-faults stop time (sim-s; the bench runs 10): traffic starts at
# 2 s and the fault episodes lie in [2.2 s, 2.9 s)
SOCKS_FAULTS_STOP_S = 3.0
# snapshot cadence (sim-s, from the first event at 1 s): the first
# snapshot lands at the first chunk boundary past 1.75 s (~2.06 s, no
# fault yet), the second at the first boundary whose window start is
# past 2.5 s. The fetch wave ends by ~2.3 s, so after the host_down
# batch the next event is at 3.0 s: the second save comes at the 2.4 s
# fault boundary, before that fault applies, with the loss and
# host_down episodes on
SOCKS_FAULTS_CKPT_S = 0.75
SOCKS_FAULTS_KEEP = 2


def socks10k_faults_sim():
    """socks10k to SOCKS_FAULTS_STOP_S under phase 17's fault schedule."""
    from shadow_tpu_torch.baseline_configs import (apply_runahead,
                                                   build_socks, socks_caps)
    from shadow_tpu_torch.core.config import FaultSpec
    from shadow_tpu_torch.engine.sim import Simulation
    ms = 10**6
    scen = build_socks(10_000, hops=1, stop=SOCKS_FAULTS_STOP_S, count=0,
                       pause="5s")
    scen.faults = [FaultSpec(kind="host_down", at=2300 * ms,
                             until=2700 * ms, host=f"relay{i}")
                   for i in range(1, 51)] + [
        FaultSpec(kind="loss", at=2200 * ms, until=2800 * ms, rate=0.05,
                  src="relay51", dst="server1"),
        FaultSpec(kind="latency", at=2400 * ms, until=2900 * ms,
                  extra_ns=5 * ms, src="client1", dst="relay52")]
    return apply_runahead(Simulation(scen, engine_cfg=socks_caps(10_000, 96),
                                     device="cuda"), 10)


def socks10k_faults_phase(defs):
    """17. faulted socks10k, checkpointed, and resumed from inside the
    fault episodes (in a child process beside phases 7-16)."""
    import shutil
    import tempfile

    from shadow_tpu_torch.apps.base import APP_SOCKS_CLIENT
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "a.jsonl"), os.path.join(tmp, "b.jsonl")
        base = os.path.join(tmp, "ck")
        sim = socks10k_faults_sim()
        rep = sim.run(digest=a, digest_every=16, checkpoint_path=base,
                      checkpoint_every_s=SOCKS_FAULTS_CKPT_S,
                      checkpoint_keep=SOCKS_FAULTS_KEEP)
        s, d = rep.summary(), rep.durability
        clients = rep.stats[(sim.hp.app_kind[:, 0] == APP_SOCKS_CLIENT)
                            .cpu().numpy()]
        out = dict(rates(rep), stop_sim_s=SOCKS_FAULTS_STOP_S,
                   faults_applied=s["faults_applied"], rsts=d["rsts"],
                   clients_done=int((clients[:, defs.ST_XFER_DONE] > 0)
                                    .sum()),
                   transfers_done=s["transfers_done"], drop_q=s["drop_q"],
                   drop_net=s["drop_net"],
                   snapshots=[{k: (round(v, 3) if k == "wall_s" else v)
                               for k, v in x.items() if k != "file"}
                              for x in d["saves"]],
                   digest_records=d["digest_records"],
                   digest_bytes=d["digest_bytes"],
                   digest_ms_per_record=round(
                       d["digest_wall_s"] * 1e3 / d["digest_records"], 3))
        print(f"  socks10k-faults run A: {json.dumps(out)}", flush=True)
        if s["faults_applied"] != 104 or not d["rsts"] or s["drop_q"]:
            fail(f"socks10k-faults: fault schedule not applied as built, "
                 f"no RST sent, or queue drops: {out}")
        if not out["clients_done"]:
            fail("socks10k-faults: no client completed a fetch")
        with open(a) as f:
            timeline = [(r["window"], r["sim_ns"], r["kind"][0]) for r in
                        map(json.loads, f.read().splitlines())]
        print(f"  socks10k-faults chain (window, sim_ns, kind): "
              f"{json.dumps(timeline, separators=(',', ':'))}")
        print(f"  socks10k-faults snapshots (wstart, windows, fault_idx): "
              f"{[x[1:] for x in _snapshots(base)]}", flush=True)
        snap, snap_ns, snap_w, snap_f = _snapshot_inside(
            base, sim.injector, 2300 * 10**6, 2700 * 10**6)
        shutil.copy(a, b)
        simb = socks10k_faults_sim()
        repb = simb.run(digest=b, digest_every=16, resume_from=snap)
        same = _chain(a) == _chain(b)
        if not same or not (repb.stats == rep.stats).all() or \
                repb.faults != rep.faults:
            fail(f"socks10k-faults: run B (resumed at {snap_ns} ns) "
                 f"differs from run A: chain equal {same}")
        phase("socks10k-faults", time.perf_counter() - t0,
              run_a_wall_s=round(rep.wall_seconds, 3),
              resumed_at_ns=snap_ns, resumed_at_window=snap_w,
              resumed_at_fault=f"{snap_f}/{len(sim.injector.events)}",
              load_s=round(repb.durability["load_s"], 3),
              run_b=json.dumps(rates(repb)), chains_equal=True,
              stats_equal=True)


def _cli_tgen_child(conn):
    """A child process: examples/tgen-web-bulk.xml through the CLI on the
    card, from the repository root (its graph paths are relative to the
    working directory) -> (rc, summary, transfers per host, wall s)."""
    from shadow_tpu_torch.__main__ import main as cli
    from shadow_tpu_torch.engine import defs
    from shadow_tpu_torch.engine import sim as S
    t0 = time.perf_counter()
    reports = []
    run = S.Simulation.run

    def keep(self, *a, **kw):
        reports.append(run(self, *a, **kw))
        return reports[-1]

    S.Simulation.run = keep
    os.chdir(HERE)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli(["examples/tgen-web-bulk.xml", "--summary-json"])
        s = json.loads(buf.getvalue().strip().splitlines()[-1])
        rep = reports[-1]
        xfer = {n: int(rep.stats[i, defs.ST_XFER_DONE])
                for i, n in enumerate(rep.host_names)}
        conn.send((rc, s, xfer, time.perf_counter() - t0))
    except BaseException as e:
        conn.send((f"{type(e).__name__}: {e}", None, None, None))
        raise


def _child_main(target, conn, *args):
    """A Child's process: the graph-path check of the main process, then
    the phase."""
    check_graph_runs()
    target(conn, *args)


class Child:
    """A phase run by a spawned child process on the same card while the
    main process runs others: its passes are host-bound, and the card
    serves a few such processes at about the speed of one (PERF.md §6).
    `target(conn, *args)` sends one result through `conn`."""

    def __init__(self, target, name, args=()):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.name = name
        self.conn, child = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_child_main,
                                args=(target, child) + tuple(args))
        self.proc.start()

    def result(self):
        """Wait for the child's result -> (it, seconds waited)."""
        t0 = time.perf_counter()
        while not self.conn.poll(1):
            if not self.proc.is_alive() and not self.conn.poll(0):
                fail(f"{self.name}: its process exited "
                     f"{self.proc.exitcode} with no result")
        return self.conn.recv(), time.perf_counter() - t0

    def wait_for(self, event):
        """Wait until the child sets `event` or sends its result (a
        failure before the event)."""
        while not event.wait(1):
            if self.conn.poll(0):
                return
            if not self.proc.is_alive():
                fail(f"{self.name}: its process exited "
                     f"{self.proc.exitcode} with no result")

    def stop(self):
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join()


class CliTgen(Child):
    """7. cli-tgen, run by a child process while phases 8-16 run:
    every web host completes 10 transfers and every bulk host 5."""

    def __init__(self):
        super().__init__(_cli_tgen_child, "cli tgen-web-bulk")

    def finish(self):
        (rc, s, xfer, wall), waited = self.result()
        if s is None:
            fail(f"cli tgen-web-bulk: {rc}")
        want = {n: 10 if n.startswith("web") else 5 for n in xfer
                if not n.startswith("server")}
        short = {n: xfer[n] for n in want if xfer[n] != want[n]}
        if rc != 0 or s["device"] != "cuda" or short or not s["drop_net"]:
            fail(f"cli tgen-web-bulk: rc={rc} hosts short of their "
                 f"transfers {short} {s}")
        phase("cli-tgen", wall, waited_s=round(waited, 3),
              events=s["events"], windows=s["windows"], passes=s["passes"],
              transfers=s["transfers_done"], drop_net=s["drop_net"],
              retransmits=s["retransmits"],
              per_host=json.dumps(xfer, separators=(",", ":")))


def _tgen_gpu_cpu_child(conn):
    """A child process: phase 13 -> None, or the failure."""
    from shadow_tpu_torch.engine.window import canonicalize_state
    try:
        tgen_gpu_cpu_phase(canonicalize_state)
        conn.send(None)
    except BaseException as e:
        conn.send(f"{type(e).__name__}: {e}")
        raise


def _socks10k_faults_child(conn):
    """A child process: phase 17 -> None, or the failure."""
    from shadow_tpu_torch.engine import defs
    try:
        socks10k_faults_phase(defs)
        conn.send(None)
    except BaseException as e:
        conn.send(f"{type(e).__name__}: {e}")
        raise


if __name__ == "__main__":
    sys.exit(main())
