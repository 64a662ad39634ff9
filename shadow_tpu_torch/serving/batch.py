"""Scenario batching: same-shape scenarios as lanes of one program.

Counterpart of ``shadow_tpu/serving/batch.py``. A parameter sweep's
scenarios usually share one EngineConfig and differ only in Shared
values (seed, stop time, latency tables). The reference runs them as
one vmapped program; here their state stacks along the row axis (row
b*H + h is host h of lane b, ``engine.state.stack_rows``) and
``engine.window.run_windows_batch`` drains every lane in one pass per
step, so B lanes share one run's launches and host syncs.

Each lane's window trajectory is its individual run's: a lane whose
chunk or run has ended is frozen, as jax's batched while_loop freezes a
finished lane. Every lane gets its own digest chain (cadence and final
records on the windows a single run records), its own summary and its
own perf-ledger entry, and ``tools/divergence.py`` exits 0 against the
same scenario run alone (tests/test_torch_serving.py).

Batch runs are plainer than ``Simulation.run``: no hosted apps, no
fault schedules, no pcap, no checkpoint/resume (the fleet re-runs a
crashed batch from scratch). They keep digest chains, summaries, ledger
entries, netscope and the fleet's liveness heartbeat.

CLI (``python -m shadow_tpu_torch batch ...``)::

  python -m shadow_tpu_torch batch a.xml b.xml c.xml [--digest-dir D]
  python -m shadow_tpu_torch batch sweep.xml --seeds 1,2,3,4 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


class BatchShapeError(ValueError):
    """The scenarios do not share one shape (EngineConfig or tensor
    shapes differ), or one of them needs per-run host state — run them
    individually, or align their configs."""


def _shapes(sim):
    from dataclasses import fields
    return [tuple(getattr(t, f.name).shape)
            for t in (sim.hosts, sim.hp, sim.sh) for f in fields(t)]


def check_same_shape(sims) -> None:
    """Every member must stack: identical EngineConfig, tensor shapes
    and device. Differing Shared *values* (seed, stop time, latency
    tables) are what batching is for."""
    cfg0 = sims[0].cfg
    for i, s in enumerate(sims[1:], 1):
        if s.cfg != cfg0:
            raise BatchShapeError(
                f"member {i} resolves a different EngineConfig than "
                f"member 0 — not one shape:\n  0: {cfg0}\n  {i}: {s.cfg}")
        if _shapes(s) != _shapes(sims[0]):
            raise BatchShapeError(
                f"member {i}'s state tensors differ in shape from "
                "member 0's (different topology/app tables?) — "
                "members must share one shape")
        if s.device != sims[0].device:
            raise BatchShapeError(
                f"member {i} runs on {s.device}, member 0 on "
                f"{sims[0].device}")
    for i, s in enumerate(sims):
        if s.hosting is not None:
            raise BatchShapeError(
                f"member {i} hosts real processes; batching covers "
                "modeled scenarios only")
        if s.injector is not None:
            raise BatchShapeError(
                f"member {i} schedules faults; batching covers plain "
                "runs only (fault surgery needs per-run host state)")
        if s.cfg.tracecap:
            raise BatchShapeError(
                f"member {i} enables pcap tracing; batching covers "
                "plain runs only")


def run_batch(sims, names=None, digest_paths=None, digest_every=0,
              netscope_paths=None, verbose=False):
    """Run B same-shape Simulations as lanes of one state.

    `digest_paths` (optional, len B) gives each lane its own digest
    chain and manifest at `digest_every` (default
    obs.digest.DEFAULT_EVERY), recorded on the windows the scenario's
    run alone records. With ``EngineConfig.netscope`` each lane gets
    its own network observatory, sampled on its own chunk boundaries
    (a frozen lane stops sampling, as a finished run does);
    `netscope_paths` streams each lane's records to a file. Returns one
    SimReport per lane; wall_seconds is the whole batch's wall,
    ``passes`` the lane's own (the passes in which it had a row to
    step, which equal its run alone's) and ``batch`` the lane count and
    the stacked passes."""
    import torch

    from ..core.simtime import SIMTIME_MAX
    from ..engine import defs
    from ..engine.sim import SimReport
    from ..engine.state import lane_rows, stack_rows, stack_shared
    from ..engine.window import run_windows_batch
    from ..obs import digest as DG
    from ..obs import memscope as MS
    from ..obs import netscope as NSC
    from ..obs import passcope as PC

    B = len(sims)
    if B < 1:
        raise BatchShapeError("a batch needs at least one member")
    check_same_shape(sims)
    cfg = sims[0].cfg
    H = cfg.num_hosts
    dev = sims[0].device
    for s in sims:
        if s._ran:
            raise RuntimeError("Simulation objects are single-use")
        s._ran = True
    names = list(names or [f"member{i}" for i in range(B)])

    nsrecs = None
    if cfg.netscope:
        if netscope_paths is not None and len(netscope_paths) != B:
            raise ValueError(f"{len(netscope_paths)} netscope paths for "
                             f"{B} members")
        nsrecs = [NSC.NetScope(netscope_paths[i]
                               if netscope_paths is not None else None)
                  for i in range(B)]
    elif netscope_paths is not None:
        raise BatchShapeError(
            "netscope_paths given but the members' EngineConfig has "
            "netscope off — the histograms are part of the state's "
            "shape, so enable it on every member")

    recorders = None
    if digest_paths is not None:
        if len(digest_paths) != B:
            raise ValueError(f"{len(digest_paths)} digest paths for "
                             f"{B} members")
        every = digest_every or DG.DEFAULT_EVERY
        recorders = [DG.DigestRecorder(p, every=every)
                     for p in digest_paths]
        for s, dg in zip(sims, recorders):
            dg.write_manifest(DG.build_manifest(
                s.scenario, s.cfg, s.seed, s.sh, s.host_names, dg,
                s.device))
            dg.begin_run(0)
    chunk = sims[0].effective_chunk(
        recorders[0].every if recorders is not None else 0)

    st = stack_rows([s.hosts for s in sims])
    hp = stack_rows([s.hp for s in sims])
    sh = stack_shared([s.sh for s in sims], H)
    for s in sims:
        s.hosts = None          # the lanes' rows now live in `st`
    ws = st.eq_next.view(B, H).min(1).values
    we = torch.where(ws == SIMTIME_MAX, SIMTIME_MAX, ws + sh.min_jump)
    lane_passes = torch.zeros(B, dtype=torch.int64, device=dev)
    stops = sh.stop_time.tolist()
    total_windows = [0] * B
    done = [False] * B
    wm = MS.Watermark(dev)
    # the fleet's liveness signal (SHADOW_TPU_FLEET_RUN_DIR), per chunk
    hb_dir = os.environ.get("SHADOW_TPU_FLEET_RUN_DIR")
    hb_path = os.path.join(hb_dir, "heartbeat") if hb_dir else None

    def lane_now(i, w):
        return min(w, stops[i]) if w < SIMTIME_MAX else stops[i]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    wall0 = time.perf_counter()
    passes = 0
    try:
        while not all(done):
            n, npass = run_windows_batch(st, hp, sh, ws, we, cfg, chunk,
                                         lane_passes)
            passes += npass
            wm.sample()
            n_l, w_l = n.tolist(), ws.tolist()
            if hb_path is not None:
                try:
                    with open(hb_path, "w") as f:
                        f.write(f"{min(w_l)}\n")
                except OSError:
                    pass        # liveness is best-effort, never fatal
            for i in range(B):
                if done[i]:
                    continue
                total_windows[i] += n_l[i]
                lane = lane_rows(st, i, H)
                if nsrecs is not None:
                    nsrecs[i].sample(total_windows[i],
                                     lane_now(i, w_l[i]),
                                     lane.ns_hist.sum(0).cpu().numpy(),
                                     lane.stats.cpu().numpy(),
                                     conns=int(lane.sk_used.sum()))
                # a single run's record order: cadence when due after
                # the chunk, then the final record when the lane ends
                if (recorders is not None
                        and recorders[i].due(total_windows[i])):
                    recorders[i].record(lane, H, total_windows[i],
                                        lane_now(i, w_l[i]), "cadence")
                if w_l[i] >= stops[i] or w_l[i] >= SIMTIME_MAX:
                    if recorders is not None:
                        recorders[i].record(lane, H, total_windows[i],
                                            lane_now(i, w_l[i]), "final")
                    done[i] = True
            if verbose:
                print(f"  batch: {sum(done)}/{B} done, windows="
                      f"{total_windows}")
        sync()
        wall = time.perf_counter() - wall0
    finally:
        if recorders is not None:
            for dg in recorders:
                dg.close()

    wm.sample()
    mem = wm.snapshot()
    lp = lane_passes.tolist()
    w_l = ws.tolist()
    reports = []
    for i, s in enumerate(sims):
        lane = lane_rows(st, i, H)
        s.final_hosts = lane
        stats = lane.stats.cpu().numpy()
        peaks = lane.cap_peaks.max(0).values.tolist()
        capacity = {"rows": [
            ("event_queue", cfg.qcap, int(peaks[0])),
            ("socket_table", cfg.scap, int(peaks[1])),
            ("outbox", cfg.obcap, int(peaks[2])),
            ("nic_txq", cfg.txqcap, int(peaks[3])),
        ]}
        census = MS.state_census(cfg, hosts=lane,
                                 hp=lane_rows(hp, i, H), sh=s.sh)
        memory = dict(mem, **MS.census_totals(census), census=census)
        network = {}
        if nsrecs is not None:
            network = NSC.report(lane.ns_hist.sum(0).cpu().numpy())
            network["records"] = len(nsrecs[i].records)
            if nsrecs[i].path:
                network["path"] = nsrecs[i].path
            nsrecs[i].close()
        occ = PC.occupancy({"dense": (H, lp[i])},
                           int(stats[:, defs.ST_EVENTS].sum()), 1)
        reports.append(SimReport(
            stats=stats, host_names=s.host_names,
            sim_time_ns=lane_now(i, w_l[i]), wall_seconds=wall,
            windows=total_windows[i], capacity=capacity,
            device=str(dev), passes=lp[i], memory=memory,
            network=network, occupancy=occ,
            batch={"lanes": B, "stacked_passes": passes}))
    return reports


# --- CLI -------------------------------------------------------------------

# the reference's batch takes no mesh either (shadow_tpu/serving/batch.py)
NO_MESH = ("batch lanes take no mesh; run a sharded scenario on its own "
           "(python -m shadow_tpu_torch CONFIG --workers N)")


def main(argv=None) -> int:

    p = argparse.ArgumentParser(
        prog="python -m shadow_tpu_torch batch",
        description="run N same-shape scenarios as lanes of one "
                    "program (one drain pass steps every lane)")
    p.add_argument("configs", nargs="+",
                   help="scenario XML path(s); with --seeds, exactly "
                        "one, replicated per seed")
    p.add_argument("--seeds", default=None, metavar="S1,S2,...",
                   help="replicate the single config across these "
                        "seeds (member ids <stem>-s<seed>)")
    p.add_argument("--stop-time", default=None, metavar="TIME",
                   help="override every member's stop time")
    p.add_argument("--runahead", default=None, metavar="TIME",
                   help="override every member's lookahead window")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--digest-dir", default=None, metavar="DIR",
                   help="per-member digest chains: DIR/<member>."
                        "digest.jsonl (+ manifests)")
    p.add_argument("--digest-paths", default=None, metavar="P1,P2,...",
                   help="explicit per-member digest chain paths "
                        "(comma-separated, member order)")
    p.add_argument("--digest-every", type=int, default=0,
                   metavar="WINDOWS")
    p.add_argument("--netscope", action="store_true",
                   help="network observatory per lane: a network "
                        "report in each member's summary and one "
                        "cross-lane ensemble JSON line")
    p.add_argument("--netscope-dir", default=None, metavar="DIR",
                   help="per-member netscope streams: DIR/<member>."
                        "netscope.jsonl (implies --netscope)")
    p.add_argument("--netscope-paths", default=None,
                   metavar="P1,P2,...",
                   help="explicit per-member netscope stream paths "
                        "(implies --netscope)")
    p.add_argument("--aot-cache", default=None, metavar="DIR",
                   help="keep the native kernel library in DIR "
                        "(serving.aotcache); the lanes run eager")
    p.add_argument("--workers", type=int, default=0, metavar="N",
                   help="refused: " + NO_MESH)
    p.add_argument("--perf", nargs="?", const="", default=None,
                   metavar="LEDGER",
                   help="append one perf-ledger entry per member (the "
                        "wall is the whole batch's, noted in the entry)")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--summary-json", action="store_true",
                   help="print one summary JSON line per member")
    args = p.parse_args(argv)

    if args.aot_cache:
        from . import aotcache as AC
        AC.install(args.aot_cache)
    if args.workers:
        p.error(f"--workers: {NO_MESH}")

    import dataclasses

    from ..core.config import load_xml
    from ..core.simtime import parse_time
    from ..engine.sim import Simulation

    if args.seeds:
        if len(args.configs) != 1:
            p.error("--seeds takes exactly one config XML")
        try:
            seeds = [int(s) for s in args.seeds.split(",") if s.strip()]
        except ValueError:
            p.error(f"--seeds {args.seeds!r}: not integers")
        if not seeds:
            p.error("--seeds names no seeds")
        if len(set(seeds)) != len(seeds):
            p.error(f"--seeds {args.seeds!r} lists duplicates — member "
                    "ids (and their digest chains) are named by seed")
        stem = os.path.splitext(os.path.basename(args.configs[0]))[0]
        members = [(f"{stem}-s{s}", args.configs[0], s) for s in seeds]
    else:
        members = [(os.path.splitext(os.path.basename(path))[0], path,
                    None) for path in args.configs]
        if len({m[0] for m in members}) != len(members):
            p.error("duplicate member stems; give distinct config "
                    "basenames (per-member outputs are named by stem)")

    netscope = bool(args.netscope or args.netscope_dir
                    or args.netscope_paths)
    sims, names = [], []
    for name, path, seed in members:
        try:
            scen = load_xml(path)
        except (OSError, ValueError) as e:
            p.error(f"{path}: {e}")
        if args.stop_time:
            scen.stop_time = parse_time(args.stop_time, default_unit="s")
        if seed is not None:
            scen.seed = seed
        sim = Simulation(scen, device=args.device)
        if netscope:
            # the histograms are part of the state's shape: rebuild
            # with the knob on (the topology is reused)
            sim = Simulation(scen, topology=sim.topo, device=args.device,
                             engine_cfg=dataclasses.replace(
                                 sim.cfg, netscope=True))
        if args.runahead:
            ra = parse_time(args.runahead, default_unit="ms")
            sim.sh.min_jump = sim.sh.min_jump.new_tensor(max(ra, 1))
        sims.append(sim)
        names.append(name)

    digest_paths = None
    if args.digest_paths:
        digest_paths = [s for s in args.digest_paths.split(",") if s]
        if len(digest_paths) != len(sims):
            p.error(f"--digest-paths names {len(digest_paths)} paths "
                    f"for {len(sims)} members")
    elif args.digest_dir:
        os.makedirs(args.digest_dir, exist_ok=True)
        digest_paths = [os.path.join(args.digest_dir, f"{n}.digest.jsonl")
                        for n in names]

    netscope_paths = None
    if args.netscope_paths:
        netscope_paths = [s for s in args.netscope_paths.split(",") if s]
        if len(netscope_paths) != len(sims):
            p.error(f"--netscope-paths names {len(netscope_paths)} "
                    f"paths for {len(sims)} members")
    elif args.netscope_dir:
        os.makedirs(args.netscope_dir, exist_ok=True)
        netscope_paths = [os.path.join(args.netscope_dir,
                                       f"{n}.netscope.jsonl")
                          for n in names]

    try:
        reports = run_batch(sims, names=names, digest_paths=digest_paths,
                            digest_every=args.digest_every,
                            netscope_paths=netscope_paths,
                            verbose=args.verbose)
    except BatchShapeError as e:
        p.error(str(e))

    B = len(reports)
    for name, rep in zip(names, reports):
        s = rep.summary()
        print(json.dumps({"member": name, "events": s["events"],
                          "windows": s["windows"],
                          "passes": s["passes"],
                          "sim_seconds": s["sim_seconds"],
                          "batch_wall_seconds": round(rep.wall_seconds, 3),
                          "batch": B,
                          "stacked_passes": rep.batch["stacked_passes"],
                          "device": s["device"]}), flush=True)
        if args.summary_json:
            print(json.dumps(s), flush=True)

    if netscope:
        from ..obs import netscope as NSC
        ens = NSC.ensemble([
            [r.network["kinds"][n]["buckets"] for n in NSC.KIND_NAMES]
            for r in reports if r.network.get("kinds")])
        print(json.dumps({"netscope_ensemble": {
            "runs": ens.get("runs", 0),
            "kinds": {name: {f: k[f] for f in
                             ("count", "p50_us", "p90_us", "p99_us",
                              "lane_p50_us", "lane_p99_us")}
                      for name, k in ens.get("kinds", {}).items()},
        }}), flush=True)

    if args.perf is not None:
        from ..obs import ledger as LG
        for name, rep, sim in zip(names, reports, sims):
            entry = LG.entry_from_report(
                name,
                LG.fingerprint_of(sim.cfg, seed=sim.scenario.seed,
                                  stop_ns=int(sim.scenario.stop_time),
                                  runahead=args.runahead or "",
                                  workers=0, engine=LG.ENGINE, batch=B),
                sim.device.type, rep, cfg=sim.cfg,
                note=(f"batch member ({B} lanes stacked on the row "
                      "axis; the wall is the whole batch's, so the "
                      "rate reads as this member's share)"))
            lpath = LG.append(entry, args.perf or None)
            if lpath:
                sys.stderr.write(f"shadow_tpu_torch: batch: perf ledger "
                                 f"+= {lpath} ({name})\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
