"""Command line: run a Shadow XML scenario on the PyTorch port.

    python -m shadow_tpu_torch CONFIG [--stop-time T] [--seed N]
        [--engine-caps K=V,...] [--runahead TIME] [--summary-json]
        [--device cuda|cpu] [--fault K=V,...]...
        [--cpu-threshold US] [--cpu-precision US]
        [--digest FILE [--digest-every WINDOWS]]
        [--checkpoint PATH --checkpoint-every SEC [--checkpoint-keep N]]
        [--resume PATH|latest]
        [--until-complete [--max-retries N] [--retry-backoff SEC]]

Runs on the card unless ``--device cpu`` is given. Prints the applied
faults, the summary, the capacity report and, with ``--summary-json``,
the summary as one JSON line last. The robustness flags have the
reference CLI's meanings (``python -m shadow_tpu``): ``--until-complete``
re-runs ``python -m shadow_tpu_torch`` in a child process with
``--resume latest`` after each crash, and SIGTERM under
``--checkpoint`` saves a snapshot at the next chunk boundary and exits
75.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import sys
import threading

_CAPS = {"qcap", "scap", "obcap", "incap", "txqcap", "chunk_windows",
         "hostedcap", "tracecap"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m shadow_tpu_torch",
                                description=__doc__.splitlines()[0])
    p.add_argument("config", help="shadow.config.xml path")
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
    p.add_argument("--summary-json", action="store_true",
                   help="print the final summary as one JSON line")
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
                        "start fresh with a warning)")
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

    if args.checkpoint and not args.checkpoint_every:
        p.error("--checkpoint requires --checkpoint-every SEC")
    if args.until_complete:
        if not (args.checkpoint and args.checkpoint_every):
            p.error("--until-complete requires --checkpoint PATH and "
                    "--checkpoint-every SEC (resume needs snapshots)")
        from .engine.supervisor import Supervisor, strip_supervisor_args
        return Supervisor(
            strip_supervisor_args(argv if argv is not None
                                  else sys.argv[1:]),
            args.checkpoint, max_retries=args.max_retries,
            backoff_s=args.retry_backoff).run()

    from .core.config import FaultSpec, load_xml
    from .core.simtime import parse_time
    from .engine.sim import Preempted, Simulation, auto_engine_config
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

    scenario = load_xml(args.config)
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

    topo = build_topology(scenario.topology_graphml or scenario.topology_path)
    cfg = auto_engine_config(scenario, topo)
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
                         digest_context=ctx)
    except Preempted as pe:
        from .engine.supervisor import EXIT_PREEMPTED
        sys.stderr.write(f"shadow_tpu_torch: preempted: {pe} — resume "
                         "with --resume latest\n")
        return EXIT_PREEMPTED
    s = report.summary()
    for rec in report.faults:
        print(f"fault applied: {rec}")
    print(f"done: {s['events']} events in {s['wall_seconds']:.2f}s wall "
          f"({s['events_per_sec']:.0f} ev/s, speedup x{s['speedup']:.2f}) "
          f"on {s['device']}")
    for row in report.capacity_report():
        print(f"capacity {row['array']}: peak {row['peak']}"
              f"/{row['capacity']}, overflow {row['overflow']}")
    if args.summary_json:
        print(json.dumps(s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
