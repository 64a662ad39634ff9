"""Command line: run a Shadow XML scenario on the PyTorch port.

    python -m shadow_tpu_torch (CONFIG | --test [--test-clients N])
        [--stop-time T] [--seed N] [--engine-caps K=V,...]
        [--runahead TIME] [--summary-json] [--device cuda|cpu]
        [--fault K=V,...]... [--cpu-threshold US] [--cpu-precision US]
        [--tcp-congestion-control aimd|reno|cubic] [--tcp-windows PKTS]
        [--tcp-ssthresh PKTS] [--socket-recv-buffer BYTES]
        [--socket-send-buffer BYTES] [--interface-buffer BYTES]
        [--interface-qdisc fifo|rr]
        [--heartbeat-frequency SEC] [--log-level LEVEL] [--verbose]
        [--pcap-dir DIR] [--trace FILE] [--metrics FILE]
        [--netscope FILE] [--perf [LEDGER]]
        [--digest FILE [--digest-every WINDOWS]]
        [--checkpoint PATH --checkpoint-every SEC [--checkpoint-keep N]]
        [--resume PATH|latest]
        [--until-complete [--max-retries N] [--retry-backoff SEC]]
        [--passcope [DIR]] [--shape-fingerprint] [--workers N]
    python -m shadow_tpu_torch batch CONFIG... [--seeds S1,S2,...] ...
    python -m shadow_tpu_torch fleet submit|run|status QUEUE ...

Runs on the card unless ``--device cpu`` is given. Prints the applied
faults, each hosted process's exit (``hosted <host>: exit_status=...``,
a warning unless it was clean), the summary, the capacity report and,
with ``--summary-json``, the summary as one JSON line last. The flags
have the reference CLI's meanings (``python -m shadow_tpu``). Telemetry:
``--heartbeat-frequency`` logs tracker heartbeats, ``--pcap-dir`` writes
pcap files for hosts with ``logpcap``, ``--trace`` a Chrome trace-event
timeline (``tools/trace_report.py``), ``--metrics`` a metrics.json
snapshot with per-chunk lines beside it, ``--netscope`` the network
observatory's time-series (the summary gains exact RTT and completion
tails), and ``--perf`` prints the per-phase wall attribution and appends
one entry to the perf ledger (``perf/ledger.jsonl`` unless a path is
given; ``SHADOW_TPU_LEDGER=off`` disables appends). ``--until-complete``
re-runs ``python -m shadow_tpu_torch`` in a child process with
``--resume latest`` after each crash, and SIGTERM under ``--checkpoint``
saves a snapshot at the next chunk boundary and exits 75.
``--passcope`` profiles the first chunks and prints the per-pass table
(obs.passcope) with the occupancy block; ``--workers N`` block-shards
the hosts over a mesh of N shards on the run's device (the reference's
worker-thread knob; parallel.shard, same results bit for bit);
``--shape-fingerprint`` prints the scenario's shape identity as one
JSON line and exits without running. ``batch`` runs same-shape scenarios as lanes of one program
(serving.batch), ``fleet`` queues and supervises sweeps (fleet.cli).
``--aot-cache DIR`` keeps the port's native kernel library in DIR
(serving.aotcache; ``SHADOW_TPU_TORCH_AOT_CACHE`` also sets it; without
either it builds once into ``build/kernels``), and ``--prewarm`` builds
or loads it and captures the chunk's CUDA graph without running,
printing one JSON line (the fleet's pre-warm child; on the CPU there is
nothing to capture: ``"captured": false``). A run on cuda replays one
captured graph a chunk; the summary's ``path`` says so (``eager`` and
``path_reason`` for hosted apps, a mesh, ``--passcope`` or the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import threading

_CAPS = {"qcap", "scap", "obcap", "incap", "txqcap", "chunk_windows",
         "hostedcap", "tracecap"}

TEST_TOPOLOGY = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="packetloss" attr.type="double" for="edge" id="d9" />
  <key attr.name="latency" attr.type="double" for="edge" id="d7" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="d4" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="d3" />
  <key attr.name="packetloss" attr.type="double" for="node" id="d0" />
  <graph edgedefault="undirected">
    <node id="poi-1"><data key="d0">0.0</data>
      <data key="d3">17038</data><data key="d4">2251</data></node>
    <edge source="poi-1" target="poi-1">
      <data key="d7">50.0</data><data key="d9">0.0</data></edge>
  </graph>
</graphml>"""

# The builtin benchmark scenario, the reference CLI's --test: clients
# making small downloads from one server over a single-PoI topology
TEST_SERVER_GRAPH = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="serverport" attr.type="string" for="node" id="d0" />
  <graph edgedefault="directed">
    <node id="start"><data key="d0">80</data></node>
  </graph>
</graphml>"""

TEST_CLIENT_GRAPH = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="count" attr.type="string" for="node" id="d6" />
  <key attr.name="size" attr.type="string" for="node" id="d5" />
  <key attr.name="type" attr.type="string" for="node" id="d4" />
  <key attr.name="time" attr.type="string" for="node" id="d2" />
  <key attr.name="peers" attr.type="string" for="node" id="d0" />
  <graph edgedefault="directed">
    <node id="start"><data key="d0">server:80</data></node>
    <node id="transfer">
      <data key="d4">get</data><data key="d5">18 KiB</data>
    </node>
    <node id="pause"><data key="d2">1</data></node>
    <node id="end"><data key="d6">10</data></node>
    <edge source="start" target="transfer" />
    <edge source="transfer" target="end" />
    <edge source="end" target="pause" />
    <edge source="pause" target="start" />
  </graph>
</graphml>"""


def build_test_scenario(n_clients: int = 1000, stop_s: int = 60):
    """The reference's --test scenario: one tgen server and `n_clients`
    tgen clients, each making 10 GETs of 18 KiB with 1 s pauses."""
    from .core.config import HostSpec, ProcessSpec, Scenario
    return Scenario(
        stop_time=stop_s * 10**9,
        topology_graphml=TEST_TOPOLOGY,
        hosts=[
            HostSpec(id="server", processes=[
                ProcessSpec(plugin="tgen", start_time=10**9,
                            arguments=TEST_SERVER_GRAPH)]),
            HostSpec(id="client", quantity=n_clients, processes=[
                ProcessSpec(plugin="tgen", start_time=2 * 10**9,
                            arguments=TEST_CLIENT_GRAPH)]),
        ],
    )


def main(argv=None) -> int:
    argv_in = list(argv) if argv is not None else sys.argv[1:]
    if argv_in[:1] == ["fleet"]:
        from .fleet.cli import main as fleet_main
        return fleet_main(argv_in[1:])
    if argv_in[:1] == ["batch"]:
        from .serving.batch import main as batch_main
        return batch_main(argv_in[1:])
    p = argparse.ArgumentParser(prog="python -m shadow_tpu_torch",
                                description=__doc__.splitlines()[0])
    p.add_argument("config", nargs="?", help="shadow.config.xml path")
    p.add_argument("--test", action="store_true",
                   help="run the builtin benchmark scenario (the "
                        "reference's --test)")
    p.add_argument("--test-clients", type=int, default=1000)
    p.add_argument("--stop-time", default=None,
                   help="override the scenario stop time (e.g. 30s)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--engine-caps", default=None, metavar="K=V,...",
                   help="override engine array capacities, e.g. "
                        "qcap=16,scap=2,obcap=16,incap=32,chunk=256")
    p.add_argument("--runahead", default=None, metavar="TIME",
                   help="override the lookahead window width (e.g. 10ms; "
                        "the reference's --runahead). Wider than the "
                        "minimum path latency trades causality slack for "
                        "fewer windows, as in the reference")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--workers", type=int, default=0, metavar="N",
                   help="shard the hosts over a mesh of N shards on the "
                        "run's device (cards round-robin when --device "
                        "is cuda with no index; 0 = one device; the "
                        "reference's worker-thread knob)")
    p.add_argument("--summary-json", action="store_true",
                   help="print the final summary as one JSON line")
    p.add_argument("--verbose", action="store_true",
                   help="print the sim time after every chunk")
    p.add_argument("--tcp-congestion-control", default="cubic",
                   choices=["aimd", "reno", "cubic"])
    p.add_argument("--tcp-windows", type=float, default=10.0,
                   metavar="PKTS",
                   help="initial TCP congestion window in packets "
                        "(default 10)")
    p.add_argument("--tcp-ssthresh", type=float, default=0,
                   metavar="PKTS",
                   help="initial TCP slow-start threshold in packets "
                        "(0 = discover)")
    p.add_argument("--socket-recv-buffer", type=int, default=0,
                   metavar="BYTES",
                   help="socket receive buffer for hosts that set none "
                        "(0 = autotune)")
    p.add_argument("--socket-send-buffer", type=int, default=0,
                   metavar="BYTES",
                   help="socket send buffer for hosts that set none "
                        "(0 = autotune)")
    p.add_argument("--interface-buffer", type=int, default=0,
                   metavar="BYTES",
                   help="NIC input buffer size for hosts that set none")
    p.add_argument("--interface-qdisc", default="rr",
                   choices=["fifo", "rr"],
                   help="NIC socket service discipline")
    p.add_argument("--heartbeat-frequency", type=float, default=0,
                   metavar="SEC", help="tracker heartbeat interval")
    p.add_argument("--log-level", default="message",
                   choices=["error", "warning", "message", "info", "debug"])
    p.add_argument("--pcap-dir", default=None, metavar="DIR",
                   help="write pcap files for hosts with logpcap set")
    p.add_argument("--trace", default=None, metavar="FILE",
                   help="record a Chrome trace-event timeline "
                        "(Perfetto / tools/trace_report.py)")
    p.add_argument("--metrics", default=None, metavar="FILE",
                   help="write a metrics snapshot to FILE and per-chunk "
                        "JSON lines to FILE.chunks.jsonl")
    p.add_argument("--netscope", default=None, metavar="FILE",
                   help="network observatory: count RTT/completion/"
                        "queue/retransmit latency histograms on the "
                        "device and stream a per-chunk network "
                        "time-series to FILE as JSON lines; the summary "
                        "gains exact p50/p99 read-outs and --metrics a "
                        "`net` section. Changes the state's shape (and "
                        "so the config fingerprint), never the results")
    p.add_argument("--perf", nargs="?", const="", default=None,
                   metavar="LEDGER",
                   help="per-phase wall attribution and the perf ledger: "
                        "collect spans in memory (no --trace file "
                        "needed), print the phase report after the run "
                        "and append one entry to the ledger (default "
                        "perf/ledger.jsonl; SHADOW_TPU_LEDGER=off "
                        "disables appends)")
    p.add_argument("--fault", action="append", default=None,
                   metavar="K=V,...",
                   help="schedule one fault (repeatable), e.g. "
                        "kind=host_down,at=10s,host=relay or "
                        "kind=link_down,at=5s,until=8s,src=a,dst=b or "
                        "kind=loss,at=5s,until=9s,rate=0.2,src=a,dst=b "
                        "or kind=latency,at=5s,until=9s,extra=30ms,"
                        "src=a,dst=b")
    p.add_argument("--cpu-threshold", type=int, default=None,
                   metavar="US",
                   help="CPU blocked-delay threshold in microseconds "
                        "(negative disables)")
    p.add_argument("--cpu-precision", type=int, default=None,
                   metavar="US",
                   help="round CPU delays to the nearest microseconds")
    p.add_argument("--digest", default=None, metavar="FILE",
                   help="append a determinism digest chain to FILE "
                        "(plus FILE.manifest.json; diff two chains with "
                        "tools/divergence.py)")
    p.add_argument("--digest-every", type=int, default=0,
                   metavar="WINDOWS",
                   help="digest cadence in windows (default 64; records "
                        "also land at every fault and at the end)")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="crash-safe checkpoint store base: snapshots "
                        "rotate as PATH.w<windows>.npz with a "
                        "PATH.latest pointer")
    p.add_argument("--checkpoint-every", type=float, default=0,
                   metavar="SEC")
    p.add_argument("--checkpoint-keep", type=int, default=0, metavar="N",
                   help="snapshots kept in the store (default 3)")
    p.add_argument("--resume", default=None, metavar="PATH|latest",
                   help="restore a snapshot and continue: a .npz, a "
                        "store base, or 'latest' for the newest valid "
                        "snapshot of the --checkpoint store (none yet: "
                        "start fresh with a warning). Resume covers "
                        "fault schedules and hosted apps (journal "
                        "replay)")
    p.add_argument("--passcope", nargs="?", const="", default=None,
                   metavar="DIR",
                   help="pass-time observatory (obs.passcope): profile "
                        "the first chunks into DIR (default "
                        "passcope_trace; SHADOW_TPU_PASSCOPE also "
                        "enables it) and print the per-pass table "
                        "(device ms, host issue and sync ms per label) "
                        "with the occupancy block after the run")
    p.add_argument("--shape-fingerprint", action="store_true",
                   help="print the scenario's shape identity "
                        "(fingerprint of the resolved EngineConfig and "
                        "the chunk) as one JSON line and exit without "
                        "running")
    p.add_argument("--aot-cache", default=None, metavar="DIR",
                   help="keep the native kernel library (nvcc-built, "
                        "keyed by its sources, nvcc, torch and the "
                        "device) in DIR, so a later process loads it "
                        "instead of building (serving.aotcache; "
                        "SHADOW_TPU_TORCH_AOT_CACHE also sets it)")
    p.add_argument("--prewarm", action="store_true",
                   help="build or load the kernel library and capture "
                        "the scenario's chunk graph, print one JSON line "
                        "and exit WITHOUT running (the fleet's pre-warm "
                        "child)")
    p.add_argument("--until-complete", action="store_true",
                   help="run the simulation in a child process and "
                        "re-run it with --resume latest after a crash "
                        "or preemption until it completes (needs "
                        "--checkpoint and --checkpoint-every)")
    p.add_argument("--max-retries", type=int, default=5, metavar="N",
                   help="with --until-complete: crashes retried before "
                        "giving up (default 5)")
    p.add_argument("--retry-backoff", type=float, default=1.0,
                   metavar="SEC",
                   help="with --until-complete: first backoff, "
                        "doubling to a 60 s cap")
    args = p.parse_args(argv)

    if args.aot_cache:
        from .serving import aotcache as AC
        AC.install(args.aot_cache)
    if args.checkpoint and not args.checkpoint_every:
        p.error("--checkpoint requires --checkpoint-every SEC")
    if args.until_complete:
        if not (args.checkpoint and args.checkpoint_every):
            p.error("--until-complete requires --checkpoint PATH and "
                    "--checkpoint-every SEC (resume needs snapshots)")
        from .engine.supervisor import Supervisor, strip_supervisor_args
        from .obs import metrics as MT
        from .obs import trace as TR
        # the supervisor's own spans and counters go to sidecar files;
        # the child's --trace/--metrics files stay the child's
        own_tr = bool(args.trace) and not TR.ENABLED
        own_mt = bool(args.metrics) and not MT.ENABLED
        if own_tr:
            TR.install(args.trace + ".supervisor")
        if own_mt:
            MT.install(args.metrics + ".supervisor")
        try:
            return Supervisor(
                strip_supervisor_args(argv if argv is not None
                                      else sys.argv[1:]),
                args.checkpoint, max_retries=args.max_retries,
                backoff_s=args.retry_backoff).run()
        finally:
            if own_tr:
                TR.finish()
            if own_mt:
                MT.finish()

    from .core.config import FaultSpec, load_xml
    from .core.simtime import parse_time
    from .engine.sim import Preempted, Simulation, auto_engine_config
    from .obs.logger import SimLogger
    from .routing.topology import build_topology

    if args.resume == "latest":
        if not args.checkpoint:
            p.error("--resume latest needs --checkpoint PATH to name "
                    "the store to resolve in")
        from .engine.checkpoint import resolve_latest
        args.resume = resolve_latest(args.checkpoint)
        if args.resume is None:
            sys.stderr.write(
                "shadow_tpu_torch: no usable snapshot under "
                f"{args.checkpoint!r} yet — starting fresh\n")

    if args.test:
        scenario = build_test_scenario(args.test_clients)
    elif args.config:
        scenario = load_xml(args.config)
    else:
        p.error("provide a config.xml or --test")
    if args.stop_time:
        scenario.stop_time = parse_time(args.stop_time, default_unit="s")
    if args.seed is not None:
        scenario.seed = args.seed
    for spec in args.fault or ():
        kv = {}
        for part in spec.split(","):
            k, eq, v = part.partition("=")
            if not eq:
                p.error(f"--fault entry {part!r} is not k=v")
            kv[k.strip()] = v.strip()
        if "kind" not in kv or "at" not in kv:
            p.error("--fault needs at least kind= and at=")
        try:
            scenario.faults.append(FaultSpec(
                kind=kv["kind"],
                at=parse_time(kv["at"], default_unit="s"),
                host=kv.get("host"), src=kv.get("src"),
                dst=kv.get("dst"),
                until=(parse_time(kv["until"], default_unit="s")
                       if "until" in kv else None),
                rate=float(kv.get("rate", 0.0)),
                extra_ns=(parse_time(kv["extra"], default_unit="ms")
                          if "extra" in kv else 0)))
        except ValueError as e:
            p.error(f"--fault {spec!r}: {e}")
    # only an explicit flag overrides the CPU-model values of the XML
    if args.cpu_threshold is not None:
        scenario.cpu_threshold_ns = (args.cpu_threshold * 1000
                                     if args.cpu_threshold >= 0 else -1)
    if args.cpu_precision is not None:
        scenario.cpu_precision_ns = (args.cpu_precision * 1000
                                     if args.cpu_precision >= 0 else 0)
    # the buffer flags are defaults: a host's own XML value wins
    for h in scenario.hosts:
        if args.socket_recv_buffer and h.socket_recv_buffer is None:
            h.socket_recv_buffer = args.socket_recv_buffer
        if args.socket_send_buffer and h.socket_send_buffer is None:
            h.socket_send_buffer = args.socket_send_buffer
        if args.interface_buffer and h.interface_buffer is None:
            h.interface_buffer = args.interface_buffer

    logger = SimLogger(level=args.log_level)
    logger.message(0, "main", f"shadow_tpu_torch starting: "
                   f"{scenario.total_hosts()} hosts, "
                   f"stop={scenario.stop_time / 1e9:.1f}s")
    topo = build_topology(scenario.topology_graphml or scenario.topology_path)
    cfg = auto_engine_config(scenario, topo)
    if args.netscope:
        cfg = dataclasses.replace(cfg, netscope=True)
    for kv in (args.engine_caps.split(",") if args.engine_caps else ()):
        k, _, v = kv.partition("=")
        k = {"chunk": "chunk_windows"}.get(k.strip(), k.strip())
        if k not in _CAPS:
            p.error(f"unknown engine cap {k!r}")
        try:
            cfg = dataclasses.replace(cfg, **{k: int(v)})
        except ValueError:
            p.error(f"engine cap {k}={v!r} is not an integer")

    sim = Simulation(scenario, topology=topo, engine_cfg=cfg,
                     device=args.device)
    if args.runahead:
        ra = parse_time(args.runahead, default_unit="ms")
        true_min = int(sim.sh.min_jump)
        if ra > true_min:
            sys.stderr.write(
                f"shadow_tpu_torch: warning: runahead {ra}ns exceeds the "
                f"minimum path latency {true_min}ns: cross-host arrivals "
                "may execute late (the reference gives the same warning)\n")
        sim.sh.min_jump = sim.sh.min_jump.new_tensor(max(ra, 1))
    cc = {"aimd": 0, "reno": 1, "cubic": 2}[args.tcp_congestion_control]
    if cc != sim.cfg.cc_kind:
        sim.sh.cc_kind.fill_(cc)
    if args.tcp_windows != 10.0:
        sim.sh.tcp_init_wnd.fill_(args.tcp_windows)
    if args.tcp_ssthresh:
        sim.sh.tcp_ssthresh0.fill_(args.tcp_ssthresh)
    qd = {"fifo": 0, "rr": 1}[args.interface_qdisc]
    if qd != sim.cfg.qdisc:
        sim.cfg = dataclasses.replace(sim.cfg, qdisc=qd)
    if args.shape_fingerprint:
        # every knob above is applied: the identity of what this exact
        # command line would run
        from .obs import digest as DG
        from .obs import ledger as LG
        chunk = sim.effective_chunk(
            (args.digest_every or DG.DEFAULT_EVERY) if args.digest else 0)
        fp = LG.fingerprint_of(sim.cfg, engine=LG.ENGINE)
        # w<N> folds the mesh size in: a sharded run is another shape
        print(json.dumps({"shape_fingerprint": fp,
                          "shape": f"c{chunk}.w{args.workers}.{fp}",
                          "chunk": chunk,
                          "hosts": scenario.total_hosts(),
                          "workers": args.workers}))
        return 0
    mesh = None
    if args.workers:
        from .parallel.shard import make_mesh
        mesh = make_mesh(args.workers, args.device)
    if args.prewarm:
        from .obs import digest as DG
        from .serving import aotcache as AC
        info = sim.prewarm(mesh=mesh, digest_every=(
            (args.digest_every or DG.DEFAULT_EVERY) if args.digest else 0))
        info["native_cache"] = ("miss" if AC.STATS["builds"] else
                                "hit" if AC.STATS["disk_hits"] else "none")
        info["cache_dir"] = args.aot_cache
        print(json.dumps(info))
        return 0
    # --perf collects the spans itself (in memory without --trace) and
    # reads them after the run
    own_perf_tr = False
    if args.perf is not None:
        from .obs import trace as TR
        if not TR.ENABLED:
            TR.install(args.trace)
            own_perf_tr = True
    if args.checkpoint and (threading.current_thread()
                            is threading.main_thread()):
        # SIGTERM: snapshot at the next chunk boundary, exit 75
        from .engine.sim import request_preempt
        signal.signal(signal.SIGTERM, lambda _s, _f: request_preempt())
    ctx = ({"argv": list(argv) if argv is not None else sys.argv[1:],
            "config_path": args.config} if args.digest else None)
    try:
        report = sim.run(checkpoint_path=args.checkpoint,
                         checkpoint_every_s=args.checkpoint_every,
                         checkpoint_keep=args.checkpoint_keep,
                         resume_from=args.resume, digest=args.digest,
                         digest_every=args.digest_every,
                         digest_context=ctx,
                         heartbeat_s=args.heartbeat_frequency,
                         logger=logger, pcap_dir=args.pcap_dir,
                         trace=None if own_perf_tr else args.trace,
                         metrics=args.metrics, netscope=args.netscope,
                         passcope=args.passcope, verbose=args.verbose,
                         mesh=mesh)
    except Preempted as pe:
        from .engine.supervisor import EXIT_PREEMPTED
        sys.stderr.write(f"shadow_tpu_torch: preempted: {pe} — resume "
                         "with --resume latest\n")
        return EXIT_PREEMPTED
    finally:
        if own_perf_tr:
            tr = TR.finish()
    s = report.summary()
    if own_perf_tr:
        _perf_report(args, sim, scenario, report, tr, logger)
    if args.passcope is not None or report.device_phases:
        from .obs import passcope as PC
        print(PC.format_report(report.device_phases or None,
                               report.occupancy or None))
    for kind, kk in report.network.get("kinds", {}).items():
        if kk["count"]:
            print(f"netscope {kind}: n={kk['count']} "
                  f"p50={kk['p50_us']}us p99={kk['p99_us']}us")
    for rec in report.faults:
        print(f"fault applied: {rec}")
    for hname, info in sorted(report.hosted.items()):
        line = (f"hosted {hname}: exit_status="
                f"{info.get('exit_status')} cause={info.get('cause')}")
        if info.get("clean", False):
            logger.message(report.sim_time_ns, "main", line)
        else:
            logger.warning(report.sim_time_ns, "main", line)
    print(f"done: {s['events']} events in {s['wall_seconds']:.2f}s wall "
          f"({s['events_per_sec']:.0f} ev/s, speedup x{s['speedup']:.2f}) "
          f"on {s['device']}")
    if report.shard_passes:
        print(f"shards: {report.shards} (drain passes per shard: "
              f"{report.shard_passes})")
    for row in report.capacity_report():
        print(f"capacity {row['array']}: peak {row['peak']}"
              f"/{row['capacity']}, overflow {row['overflow']}")
    if args.summary_json:
        print(json.dumps(s))
    return 0


def port_fingerprint(cfg, scenario, runahead, workers: int = 0) -> str:
    """The ledger fingerprint of a port run: the reference CLI's
    arguments (the mesh size among them) plus ``engine="torch"``, so the
    port's entries never share a trajectory with the reference's in
    tools/perf_regress.py."""
    from .obs import ledger as LG
    return LG.fingerprint_of(cfg, seed=scenario.seed,
                             stop_ns=int(scenario.stop_time),
                             runahead=runahead or "", workers=workers,
                             engine=LG.ENGINE)


def _perf_report(args, sim, scenario, report, tr, logger):
    """--perf: print where the wall went and extend the scenario's
    trajectory in the perf ledger (not for a resumed run, whose events
    span the whole run while its wall covers the tail)."""
    from .obs import ledger as LG
    from .obs import perf as PF
    att = PF.attribute(tr.events, report.wall_seconds, report.events)
    print(PF.format_report(att))
    if args.resume:
        logger.message(report.sim_time_ns, "main",
                       "perf ledger: skipping append for a resumed run "
                       "(tail-only wall would inflate the rate)")
        return
    label = ("test" if args.test else
             os.path.splitext(os.path.basename(args.config))[0])
    entry = LG.entry_from_report(
        label,
        port_fingerprint(sim.cfg, scenario, args.runahead, args.workers),
        sim.device.type, report, att, cfg=sim.cfg)
    path = LG.append(entry, args.perf or None)
    if path:
        logger.message(report.sim_time_ns, "main",
                       f"perf ledger += {path}")


if __name__ == "__main__":
    sys.exit(main())
