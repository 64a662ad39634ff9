"""``shadow_tpu_torch fleet`` — submit / run / status for sweep queues.

  python -m shadow_tpu_torch fleet submit Q config.xml [opts] [-- child args]
  python -m shadow_tpu_torch fleet submit Q --cmd [opts] -- prog arg...
  python -m shadow_tpu_torch fleet run Q [--workers N] [--metrics FILE] ...
  python -m shadow_tpu_torch fleet status Q [--json]

``submit`` durably enqueues one run (the XML is copied into the
queue, so temp files are fine); ``--batch GROUP [--seeds 1,2,..]``
enqueues batch members that execute as lanes of ONE child
(serving.batch); ``--device`` (default cuda) is the torch device the
run and batch children get. ``run`` drains the queue — restart it
after any crash or preemption and the sweep completes as if never
interrupted (docs/fleet.md); ``--aot-cache`` and ``--prewarm`` are
refused (exit 2): eager torch has no executable to cache. ``status``
folds the journal into a table.

Exit codes of ``run``: 0 queue drained, every run done; 3 drained but
some runs quarantined (their crash-cause journals are named in the
status output); 75 preempted (SIGTERM — children checkpointed and
were requeued; run again to resume); 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
from xml.etree import ElementTree


def _count_hosts(xml_path: str) -> int:
    """Admission weight from the scenario XML: total expanded hosts.
    A light direct parse — submit must not pay an engine import."""
    try:
        root = ElementTree.parse(xml_path).getroot()
    except (OSError, ElementTree.ParseError):
        return 1
    return max(sum(int(el.attrib.get("quantity", 1) or 1)
                   for el in root if el.tag in ("host", "node")), 1)


def _split_rest(argv: list) -> tuple:
    """Split the fleet argv at the first ``--``: argparse sees the
    head, the tail goes verbatim to the child (argparse.REMAINDER is
    famously greedy around optionals, so the split is manual)."""
    if "--" in argv:
        i = argv.index("--")
        return list(argv[:i]), list(argv[i + 1:])
    return list(argv), []


def _rss_weight(args, hosts: int) -> int:
    """The admission RSS weight (MiB) of one member: an explicit
    --rss-mb always wins; otherwise --mem-bytes-per-host (measured
    per-host state bytes from the memscope census) x the member's
    host count, rounded up — so admission bounds concurrent footprint
    by what a run MEASURES, not by a static host-count proxy."""
    if args.rss_mb or not args.mem_bytes_per_host:
        return args.rss_mb
    return -(-hosts * args.mem_bytes_per_host // (1 << 20))


def _auto_id(queue, stem: str) -> str:
    taken = set(queue.fold()) if queue.exists() else set()
    if stem not in taken:
        return stem
    i = 2
    while f"{stem}-{i}" in taken:
        i += 1
    return f"{stem}-{i}"


def main(argv=None) -> int:
    from ..serving import NO_EXECUTABLE_CACHE

    p = argparse.ArgumentParser(
        prog="python -m shadow_tpu_torch fleet",
        description="crash-safe sweep scheduler (docs/fleet.md)")
    sub = p.add_subparsers(dest="cmd_name", required=True)

    ps = sub.add_parser("submit", help="durably enqueue one run")
    ps.add_argument("queue", help="queue directory")
    ps.add_argument("config", nargs="?",
                    help="scenario XML (omit with --cmd)")
    ps.add_argument("--id", default=None,
                    help="run id (default: config basename, "
                         "deduplicated)")
    ps.add_argument("--cmd", action="store_true",
                    help="raw command mode: everything after -- is "
                         "the child argv (retries re-run from "
                         "scratch; no managed checkpoint/digest)")
    ps.add_argument("--hosts", type=int, default=0,
                    help="admission weight (default: parsed from the "
                         "XML; 1 for --cmd)")
    ps.add_argument("--rss-mb", type=int, default=0,
                    help="declared peak RSS for admission control")
    ps.add_argument("--mem-bytes-per-host", type=int, default=0,
                    metavar="BYTES",
                    help="measured per-host state bytes (the memscope "
                         "census — tools/capacity_plan.py or a "
                         "--perf run's state_bytes_per_host): the "
                         "admission RSS weight becomes hosts x this, "
                         "so the scheduler bounds concurrent runs by "
                         "MEASURED footprint instead of raw host "
                         "counts. Explicit --rss-mb wins")
    ps.add_argument("--max-retries", type=int, default=3,
                    help="crashes before quarantine (default 3)")
    ps.add_argument("--checkpoint-every", type=float, default=10.0,
                    metavar="SEC",
                    help="child checkpoint cadence (default 10)")
    ps.add_argument("--no-digest", action="store_true",
                    help="skip the per-run determinism digest chain")
    ps.add_argument("--digest-every", type=int, default=0,
                    metavar="WINDOWS")
    ps.add_argument("--perf", nargs="?", const="", default=None,
                    metavar="LEDGER",
                    help="append a per-run perf-ledger entry on "
                         "completion (child --perf; default ledger "
                         "path unless LEDGER given). Resumed "
                         "attempts skip the append, as documented in "
                         "docs/performance.md")
    ps.add_argument("--netscope", action="store_true",
                    help="network observatory (obs.netscope): the "
                         "child streams its per-window network "
                         "time-series into the run directory "
                         "(<run>/netscope.jsonl); `fleet status "
                         "--ensemble` folds the streams into "
                         "cross-run percentile curves")
    ps.add_argument("--batch", default=None, metavar="GROUP",
                    help="batch group (serving.batch): every member "
                         "submitted under GROUP executes in ONE child "
                         "as lanes of one program, while keeping its "
                         "own journal state and digest chain. Members "
                         "must share one shape (identical "
                         "EngineConfig); batch retries re-run the "
                         "whole group from scratch (no managed "
                         "checkpoint)")
    ps.add_argument("--device", default="cuda",
                    help="torch device of the run or batch child "
                         "(default: cuda)")
    ps.add_argument("--seeds", default=None, metavar="S1,S2,...",
                    help="with --batch: submit one member per seed "
                         "from this one XML (ids <id>-s<seed>)")
    ps.add_argument("--env", action="append", default=[],
                    metavar="K=V", help="child environment override "
                                        "(repeatable)")
    ps.epilog = ("everything after `--` goes verbatim to the child: "
                 "extra CLI args in config mode (--seed, --fault, "
                 "--engine-caps ...), the command itself in --cmd "
                 "mode")

    pr = sub.add_parser("run", help="drain the queue (restartable)")
    pr.add_argument("queue")
    pr.add_argument("--workers", type=int, default=2)
    pr.add_argument("--max-hosts", type=int, default=0,
                    help="admission cap on CONCURRENT simulated "
                         "hosts (0 = unbounded)")
    pr.add_argument("--max-rss-mb", type=int, default=0)
    pr.add_argument("--hang-timeout", type=float, default=900.0,
                    metavar="SEC",
                    help="watchdog: SIGKILL a run with no progress "
                         "signals for this long (default 900)")
    pr.add_argument("--backoff", type=float, default=1.0, metavar="SEC")
    pr.add_argument("--backoff-cap", type=float, default=60.0,
                    metavar="SEC")
    pr.add_argument("--grace", type=float, default=60.0, metavar="SEC",
                    help="preemption: wall given to children to "
                         "checkpoint after SIGTERM before SIGKILL")
    pr.add_argument("--metrics", default=None, metavar="FILE",
                    help="write fleet.* metrics (obs.metrics) to FILE")
    pr.add_argument("--python", default=None,
                    help="interpreter for child runs")
    pr.add_argument("--aot-cache", default=None, metavar="DIR",
                    help="refused: " + NO_EXECUTABLE_CACHE)
    pr.add_argument("--prewarm", action="store_true",
                    help="refused: " + NO_EXECUTABLE_CACHE)

    pt = sub.add_parser("status", help="fold the journal into a table")
    pt.add_argument("queue")
    pt.add_argument("--json", action="store_true")
    pt.add_argument("--ensemble", action="store_true",
                    help="fold the runs' netscope streams "
                         "(<run>/netscope.jsonl — submit --netscope) "
                         "into cross-run percentile curves: pooled "
                         "p50/p90/p99 + per-run tails per kind "
                         "(obs.netscope.ensemble)")

    head, rest = _split_rest(list(argv) if argv is not None
                             else sys.argv[1:])
    args = p.parse_args(head)
    if rest and args.cmd_name != "submit":
        p.error(f"`{args.cmd_name}` takes no `--` tail")
    from .queue import Queue, make_spec
    from .worker import _cfg_bytes

    if args.cmd_name == "submit":
        q = Queue(args.queue)
        env = {}
        for kv in args.env:
            k, eq, v = kv.partition("=")
            if not eq:
                p.error(f"--env {kv!r} is not K=V")
            env[k] = v
        if args.seeds and not args.batch:
            p.error("--seeds expands a batch group; give the "
                    "group a name with --batch GROUP")
        if args.cmd:
            if not rest:
                p.error("--cmd needs a command after --")
            if args.batch:
                p.error("--batch members are config runs (the batch "
                        "child stacks their engine state along the "
                        "row axis; an arbitrary command has no "
                        "such state)")
            # durability/perf args are managed for CONFIG runs only;
            # silently accepting them here would e.g. drop the user's
            # expected ledger entries without a trace
            if (args.checkpoint_every != 10.0 or args.no_digest
                    or args.digest_every or args.perf is not None
                    or args.netscope):
                p.error("--cmd runs execute the command verbatim: "
                        "--checkpoint-every/--no-digest/--digest-every"
                        "/--perf/--netscope apply to config runs only "
                        "(put the equivalent flags in the command "
                        "itself)")
            if args.config:
                rest = [args.config] + rest
            rid = args.id or _auto_id(q, "cmd")
            spec = make_spec(rid, cmd=rest, env=env,
                             hosts=args.hosts or 1,
                             rss_mb=_rss_weight(args, args.hosts or 1),
                             max_retries=args.max_retries)
        else:
            if not args.config:
                p.error("submit needs a scenario XML (or --cmd)")
            # the worker appends the MANAGED durability args after the
            # tail; argparse last-wins would silently discard any the
            # user put there — refuse instead
            managed = {"--checkpoint", "--checkpoint-every",
                       "--checkpoint-keep", "--digest",
                       "--digest-every", "--resume", "--perf",
                       "--until-complete", "--max-retries",
                       "--retry-backoff"}
            clash = [a for a in rest
                     if a in managed
                     or a.split("=", 1)[0] in managed]
            if clash:
                p.error(f"{' '.join(sorted(set(clash)))} in the `--` "
                        "tail: the fleet manages checkpoint/digest/"
                        "resume/perf for config runs — use the submit "
                        "options (--checkpoint-every, --digest-every, "
                        "--no-digest, --perf) instead")
            stem = os.path.splitext(os.path.basename(args.config))[0]
            rid = args.id or _auto_id(q, stem)
            if args.batch:
                # batch children run the group's configs verbatim
                # (serving.batch takes no per-member extra args) — a
                # `--` tail would be silently dropped; refuse instead
                if rest:
                    p.error("--batch members take no `--` tail (the "
                            "batch child runs the XMLs verbatim; "
                            "vary members by --seeds or by config)")
                if args.checkpoint_every != 10.0:
                    p.error("--checkpoint-every with --batch: batch "
                            "children carry no checkpoint store — a "
                            "crashed group re-runs from scratch "
                            "(docs/serving.md)")
                seeds = [None]
                if args.seeds:
                    try:
                        seeds = [int(s) for s in args.seeds.split(",")
                                 if s.strip()]
                    except ValueError:
                        p.error(f"--seeds {args.seeds!r}: not "
                                "integers")
                    if not seeds:
                        p.error("--seeds names no seeds")
                # group consistency: ONE batch child runs the whole
                # group, in exactly one of two forms (worker.
                # build_batch_argv) — one XML x N seeds, or one XML
                # per member. Submissions into an existing group must
                # keep its form, and the seeded form must keep its
                # one XML (by content; the queue copies per member)
                if q.exists():
                    prior = [st.spec for st in q.fold().values()
                             if st.spec.get("batch") == args.batch]
                    if prior:
                        seeded = args.seeds is not None
                        was = prior[0].get("batch_seed") is not None
                        if seeded != was:
                            form = "seeded" if was else "per-XML"
                            p.error(
                                f"batch group {args.batch!r} already "
                                f"holds {form} members; a group "
                                "mixes no forms (one child, one argv "
                                "shape — docs/serving.md)")
                        if not seeded:
                            # the batch child names per-member
                            # outputs by config stem (serving.batch);
                            # a colliding stem would only fail at RUN
                            # time as a usage-error quarantine of the
                            # whole group — refuse it here instead
                            stems = {os.path.splitext(
                                os.path.basename(s["config"]))[0]
                                for s in prior}
                            if stem in stems:
                                p.error(
                                    f"batch group {args.batch!r} "
                                    f"already holds a member whose "
                                    f"config is named {stem!r} — the "
                                    "batch child names per-member "
                                    "outputs by config basename, so "
                                    "stems must be distinct "
                                    "(docs/serving.md)")
                        if seeded and _cfg_bytes(
                                prior[0]["config"]) not in (
                                None, _cfg_bytes(args.config)):
                            p.error(
                                f"batch group {args.batch!r} is the "
                                "one-XML-many-seeds form and this XML "
                                "differs from the group's — seeded "
                                "members all run ONE config "
                                "(docs/serving.md)")
                        # the ONE batch child runs with the group's
                        # digest/perf/env settings; silently running
                        # a member at another member's settings would
                        # drop its expected ledger entry / cadence
                        # without a trace (the submit gate's
                        # principle) — refuse instead
                        group_knobs = {
                            "device": args.device,
                            "digest": not args.no_digest,
                            "digest_every": int(args.digest_every),
                            "perf": args.perf,
                            "netscope": bool(args.netscope),
                            "env": env}
                        prior_knobs = {
                            # bool-normalized: a pre-netscope journal
                            # spec has no key at all (None == off)
                            k: (bool(prior[0].get(k))
                                if k == "netscope"
                                else prior[0].get(k, "cuda")
                                if k == "device"
                                else prior[0].get(k))
                            for k in group_knobs}
                        if prior_knobs != group_knobs:
                            diff = [k for k in group_knobs
                                    if group_knobs[k]
                                    != prior_knobs[k]]
                            p.error(
                                f"batch group {args.batch!r}: "
                                f"{', '.join(diff)} differ(s) from "
                                "the group's — one child runs the "
                                "whole group, so device/digest/perf/"
                                "env settings are group-wide")
                rids = []
                n_hosts = args.hosts or _count_hosts(args.config)
                for seed in seeds:
                    mid = rid if seed is None else f"{rid}-s{seed}"
                    spec = make_spec(
                        mid, config=args.config, env=env,
                        hosts=n_hosts,
                        rss_mb=_rss_weight(args, n_hosts),
                        max_retries=args.max_retries,
                        digest=not args.no_digest,
                        digest_every=args.digest_every,
                        perf=args.perf, netscope=args.netscope,
                        batch=args.batch, batch_seed=seed,
                        device=args.device)
                    try:
                        q.submit(spec)
                    except (ValueError, OSError) as e:
                        p.error(str(e))
                    rids.append(mid)
                print(f"submitted {' '.join(rids)} -> {args.queue} "
                      f"(batch group {args.batch})")
                return 0
            n_hosts = args.hosts or _count_hosts(args.config)
            spec = make_spec(
                rid, config=args.config, args=rest, env=env,
                hosts=n_hosts,
                rss_mb=_rss_weight(args, n_hosts),
                max_retries=args.max_retries,
                checkpoint_every=args.checkpoint_every,
                digest=not args.no_digest,
                digest_every=args.digest_every, perf=args.perf,
                netscope=args.netscope, device=args.device)
        try:
            q.submit(spec)
        except (ValueError, OSError) as e:
            p.error(str(e))
        print(f"submitted {rid} -> {args.queue}")
        return 0

    if args.cmd_name == "run":
        from ..obs import metrics as MT
        from .scheduler import Scheduler, SchedulerLockError
        q = Queue(args.queue)
        if not q.exists():
            p.error(f"{args.queue!r} holds no queue journal — submit "
                    "runs first")
        if args.aot_cache is not None or args.prewarm:
            flag = "--aot-cache" if args.aot_cache is not None \
                else "--prewarm"
            p.error(f"{flag}: {NO_EXECUTABLE_CACHE}")
        sched = Scheduler(
            q, workers=args.workers, max_hosts=args.max_hosts,
            max_rss_mb=args.max_rss_mb,
            hang_timeout_s=args.hang_timeout, backoff_s=args.backoff,
            backoff_cap_s=args.backoff_cap, grace_s=args.grace,
            python=args.python)
        # SIGTERM/SIGINT = preempt: children checkpoint + requeue,
        # we exit 75; the next `fleet run` resumes the sweep
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda s, f: sched.request_preempt())
        own_mt = False
        if args.metrics and not MT.ENABLED:
            MT.install(args.metrics)
            own_mt = True
        try:
            return sched.run()
        except SchedulerLockError as e:
            sys.stderr.write(f"shadow_tpu_torch: fleet: {e}\n")
            return 1
        finally:
            if own_mt:
                MT.finish()

    # status
    q = Queue(args.queue)
    states = q.fold()
    ens = None
    if args.ensemble:
        # fold every run's netscope stream (its last record carries
        # the run's cumulative histogram) into cross-run curves —
        # runs without a stream (not submitted --netscope, or not
        # started yet) are skipped, and named
        from ..obs import netscope as NSC
        tables, members, missing = [], [], []
        for rid in states:
            path = q.netscope_path(rid)
            _, recs = (NSC.read_stream(path)
                       if os.path.exists(path) else ({}, []))
            if recs:
                tables.append(recs[-1]["hist"])
                members.append(rid)
            else:
                missing.append(rid)
        ens = NSC.ensemble(tables)
        if ens:
            ens["members"] = members
        if missing:
            ens = ens or {}
            ens["missing"] = missing
    if args.json:
        out = {rid: {**st.spec, "state": st.state,
                     "started": st.started, "crashes": st.crashes,
                     "preemptions": st.preemptions,
                     "reclaims": st.reclaims,
                     "last_rc": st.last_rc,
                     "last_cause": st.last_cause,
                     "quarantine_cause": st.quarantine_cause}
               for rid, st in states.items()}
        if ens is not None:
            out["_ensemble"] = ens
        print(json.dumps(out, indent=1, sort_keys=True))
        return 0
    if not states:
        print(f"{args.queue}: empty queue")
        return 0
    wid = max(len(r) for r in states) + 2
    print(f"{'run':<{wid}}{'state':<13}{'starts':<8}{'crashes':<9}"
          "cause")
    for rid, st in states.items():
        cause = st.quarantine_cause or st.last_cause or ""
        batch = st.spec.get("batch")
        if batch:
            cause = (f"[batch {batch}] {cause}" if cause
                     else f"[batch {batch}]")
        print(f"{rid:<{wid}}{st.state:<13}{st.started:<8}"
              f"{st.crashes:<9}{cause}")
    counts = {}
    for st in states.values():
        counts[st.state] = counts.get(st.state, 0) + 1
    print("total: " + ", ".join(f"{v} {k}"
                                for k, v in sorted(counts.items())))
    if ens is not None:
        if ens.get("kinds"):
            print(f"ensemble: {ens['runs']} runs "
                  f"({' '.join(ens['members'])})")
            for name, k in ens["kinds"].items():
                lanes = " ".join(str(v) for v in k["lane_p99_us"])
                print(f"  {name:<12}n={k['count']:<9}"
                      f"p50={k['p50_us']}us p90={k['p90_us']}us "
                      f"p99={k['p99_us']}us  per-run p99: {lanes}")
        else:
            print("ensemble: no netscope streams (submit with "
                  "--netscope)")
        if ens.get("missing"):
            print("  no stream: " + " ".join(ens["missing"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
