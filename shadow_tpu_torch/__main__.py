"""Command line: run a Shadow XML scenario on the PyTorch port.

    python -m shadow_tpu_torch CONFIG [--stop-time T] [--seed N]
        [--engine-caps K=V,...] [--runahead TIME] [--summary-json]
        [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given. Prints the summary,
the capacity report and, with ``--summary-json``, the summary as one
JSON line last.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

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
    args = p.parse_args(argv)

    from .core.config import load_xml
    from .core.simtime import parse_time
    from .engine.sim import Simulation, auto_engine_config
    from .routing.topology import build_topology

    scenario = load_xml(args.config)
    if args.stop_time:
        scenario.stop_time = parse_time(args.stop_time, default_unit="s")
    if args.seed is not None:
        scenario.seed = args.seed

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
    report = sim.run()
    s = report.summary()
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
