"""CLI for the port's static protocol analysis suite (the port of
``hpa2_tpu/analysis/__main__.py``: the same subcommands, flags,
messages and exit codes).

Subcommands::

    python -m hpa2_tpu_torch.analysis check          # static checks + spec equiv
    python -m hpa2_tpu_torch.analysis lint           # 8-rule AST lint
    python -m hpa2_tpu_torch.analysis equiv          # cross-backend table diff
    python -m hpa2_tpu_torch.analysis mutation-test  # analyzer self-test
    python -m hpa2_tpu_torch.analysis contracts      # program contracts
    python -m hpa2_tpu_torch.analysis vmem           # Hopper CTA budget model
    python -m hpa2_tpu_torch.analysis occupancy      # occupancy scheduler model
    python -m hpa2_tpu_torch.analysis elision        # cycle-elision exact replay
    python -m hpa2_tpu_torch.analysis topology       # interconnect sensitivity
    python -m hpa2_tpu_torch.analysis table          # compiled protocol planes

``check`` is the cheap gate (pure Python, no device): whole-table
static checks plus the spec-engine equivalence diff, on both the
default and robust semantics.  ``equiv`` extends the diff to the
``jax`` backend (the general engine's step), ``native`` (the C++
engine's probe) and ``pallas`` (one cycle of the fast path's per-call
kernel K3, every row a lane of one launch).  ``--device`` (the one flag
the JAX CLI lacks) picks where ``equiv``, ``contracts``, ``elision``'s
verify and ``vmem``'s card column run: ``cuda`` (the default, which
raises without a GPU) or ``cpu``, where the kernels' plain versions
run.  ``check``, ``lint``, ``mutation-test``, ``table``, ``occupancy``
and ``topology`` touch no device.  All subcommands exit non-zero on
failure.
"""

from __future__ import annotations

import argparse
import os
import sys

from hpa2_tpu_torch.config import Semantics

_SEMS = {
    "default": lambda: Semantics(),
    "robust": lambda: Semantics().robust(),
    "head": lambda: Semantics().head_quirks(),
}


def _table_report(
    name: str, sem: Semantics, verbose: bool, protocol: str = "mesi"
) -> int:
    from hpa2_tpu_torch.analysis.table import build_table
    from hpa2_tpu_torch.analysis.checks import run_static_checks

    table = build_table(sem, protocol)
    findings = run_static_checks(table)
    errors = [f for f in findings if f.severity == "error"]
    warnings = [f for f in findings if f.severity != "error"]
    print(f"[{name}/{protocol}] {len(table.rows)} rows, "
          f"{len(table.unreachable)} unreachable declarations, "
          f"{len(errors)} errors, {len(warnings)} warnings")
    shown = findings if verbose else errors
    for f in shown:
        print(f"  {f}")
    return len(errors)


def cmd_check(args: argparse.Namespace) -> int:
    from hpa2_tpu_torch.analysis.table import build_table
    from hpa2_tpu_torch.analysis.extract import diff_backend

    rc = 0
    for name in args.sem:
        sem = _SEMS[name]()
        for protocol in ("mesi", "moesi", "mesif"):
            rc += _table_report(name, sem, args.verbose, protocol)
            diffs = diff_backend(build_table(sem, protocol), "spec")
            print(f"[{name}/{protocol}] spec equivalence: "
                  f"{len(diffs)} diffs")
            for d in diffs[:20]:
                print(f"  {d}")
            rc += len(diffs)
    return 1 if rc else 0


def cmd_lint(args: argparse.Namespace) -> int:
    from hpa2_tpu_torch.analysis.lint import run_lint

    findings = run_lint(args.root)
    for f in findings:
        print(f)
    print(f"{len(findings)} lint findings")
    return 1 if findings else 0


def cmd_equiv(args: argparse.Namespace) -> int:
    from hpa2_tpu_torch.analysis.table import build_table
    from hpa2_tpu_torch.analysis.extract import (
        diff_backend, diff_multi_backend,
    )

    total = 0
    for name in args.sem:
        sem = _SEMS[name]()
        for protocol in args.protocol:
            tag = f"{name}/{protocol}"
            table = build_table(sem, protocol)
            for backend in args.backends:
                if (backend in ("jax", "pallas")
                        and sem.overloaded_evict_shared_notify):
                    # the JAX and Pallas backends refuse to build the
                    # overloaded notify quirk; nothing to extract
                    print(f"[{tag}] {backend}: skipped (overloaded "
                          f"quirk unsupported by this backend)")
                    continue
                if protocol != "mesi" and backend in ("native", "pallas"):
                    print(f"[{tag}] {backend}: skipped (backend is "
                          f"specialized to MESI)")
                    continue
                try:
                    diffs = diff_backend(table, backend,
                                         device=args.device)
                except Exception as e:  # e.g. native toolchain missing
                    if backend == "native" and args.allow_missing_native:
                        print(f"[{tag}] native: skipped ({e})")
                        continue
                    raise
                print(f"[{tag}] {backend}: {len(diffs)} diffs")
                for d in diffs[:20]:
                    print(f"  {d}")
                total += len(diffs)
            if "jax" in args.backends \
                    and not sem.overloaded_evict_shared_notify:
                diffs = diff_multi_backend(sem, protocol,
                                           device=args.device)
                print(f"[{tag}] multi-message spec<->jax: "
                      f"{len(diffs)} diffs")
                for d in diffs[:20]:
                    print(f"  {d}")
                total += len(diffs)
    return 1 if total else 0


def cmd_contracts(args: argparse.Namespace) -> int:
    from hpa2_tpu_torch.analysis import contracts as contracts_mod

    if args.list:
        for c in contracts_mod.registry():
            pinned = sum(1 for r in c.rules if r.expect is None)
            print(f"{c.name:28s} [{c.engine:7s}] {len(c.rules)} rules "
                  f"({pinned} pinned, needs {c.needs_devices} "
                  f"device(s)) — {c.title}")
        return 0
    if args.repin:
        # refuse on a dirty tree outside contracts/ so a repin diff
        # reviews as ONLY the pin churn, never mixed with source edits
        import subprocess

        proc = subprocess.run(
            ["git", "-C", args.root, "status", "--porcelain"],
            capture_output=True, text=True)
        if proc.returncode == 0:
            pin_dir = "hpa2_tpu_torch/analysis/contracts/"
            dirty = []
            for line in proc.stdout.splitlines():
                path = line[3:].split(" -> ")[-1].strip().strip('"')
                if path and not path.startswith(pin_dir):
                    dirty.append(path)
            if dirty:
                print("--repin refused: working tree dirty outside "
                      f"{pin_dir}:", file=sys.stderr)
                for path in dirty[:10]:
                    print(f"  {path}", file=sys.stderr)
                print("commit or stash source changes first, so the "
                      "pin refresh lands as its own reviewable diff",
                      file=sys.stderr)
                return 2
    results = contracts_mod.run_contracts(
        engine=args.engine, repin=args.repin, device=args.device)
    drifted = [r for r in results if r.status == "drift"]
    checked = sum(1 for r in results if r.status == "ok")
    skipped = sum(1 for r in results if r.status == "skip")
    print(f"{checked} contract(s) "
          f"{'repinned' if args.repin else 'clean'}, "
          f"{len(drifted)} drifted, {skipped} skipped")
    return 1 if drifted else 0


def cmd_vmem(args: argparse.Namespace) -> int:
    from hpa2_tpu_torch.config import SystemConfig
    from hpa2_tpu_torch.analysis.vmem import (
        budget_table, measured_vmem_bytes, vmem_budget,
    )

    cfg = SystemConfig(
        num_procs=args.procs, msg_buffer_size=args.cap,
        semantics=_SEMS[args.sem[0]](),
    )
    if args.node_shards < 1 or args.procs % args.node_shards:
        print(
            f"--node-shards {args.node_shards} must divide --procs "
            f"{args.procs} (shards own contiguous equal node blocks)",
            file=sys.stderr,
        )
        return 2
    blocks = tuple(int(b) for b in args.blocks.split(","))
    if args.node_shards > 1:
        # one rank's plane bytes: the node-sharded cycle runs no CTA, so
        # there is no shared memory to fit and no card figure to read
        print(budget_table(cfg, blocks, args.window,
                           snapshots=args.snapshots, gate=args.gate,
                           packed=args.packed, node_shards=args.node_shards))
        return 0
    kw = dict(snapshots=args.snapshots, gate=args.gate, packed=args.packed)
    measured = None
    if args.device != "cpu":
        measured = {b: measured_vmem_bytes(cfg, b, packed=args.packed,
                                           device=args.device)
                    for b in blocks
                    if vmem_budget(cfg, b, args.window, **kw).fits}
    print(budget_table(cfg, blocks, args.window, measured=measured, **kw))
    worst = vmem_budget(cfg, max(blocks), args.window, **kw)
    off = [b for b, v in (measured or {}).items()
           if v != vmem_budget(cfg, b, args.window, **kw).smem_bytes]
    if off:
        print(f"MODEL MISMATCH: the card's shared memory differs at "
              f"blocks {off}")
        return 1
    return 0 if worst.fits else 1


def cmd_occupancy(args: argparse.Namespace) -> int:
    from hpa2_tpu_torch.analysis.occupancy import occupancy_table

    table, rc = occupancy_table(
        args.batch, args.instrs, args.window, args.block,
        dists=[d.strip() for d in args.dists.split(",") if d.strip()],
        spreads=tuple(float(s) for s in args.spreads.split(",")),
        threshold=args.threshold,
        resident=args.resident,
        groups=args.groups,
        seed=args.seed,
        fused=not args.host_barriers,
        policies=[s.strip() for s in args.policy.split(",") if s.strip()],
    )
    print(table)
    if rc:
        print("MODEL VIOLATION: scheduler predicted to exceed the "
              "lockstep bound")
    return rc


def cmd_elision(args: argparse.Namespace) -> int:
    from hpa2_tpu_torch.analysis.elision import elision_table

    table, rc = elision_table(
        procs=args.procs,
        instrs=args.instrs,
        spreads=tuple(float(s) for s in args.spreads.split(",")),
        tail=args.tail,
        write_frac=args.write_frac,
        seed=args.seed,
        topology=args.topology,
        verify=not args.no_verify,
        device=args.device,
    )
    print(table)
    if rc:
        print("MODEL VIOLATION: predicted elision counters diverge "
              "from the device run")
    return rc


def cmd_topology(args: argparse.Namespace) -> int:
    from hpa2_tpu_torch.analysis.topology import topology_table

    topos = [t.strip() for t in args.topologies.split(",") if t.strip()]
    print(topology_table(
        nodes=args.nodes, rounds=args.rounds,
        hop_latency=args.hop_latency, bandwidth=args.bandwidth,
        topologies=topos,
    ))
    return 0


def cmd_table(args: argparse.Namespace) -> int:
    """Lower each requested protocol's TransitionTable and print the
    compiled plane digests — the same planes the JAX step and the spec
    dispatch run from, so a digest change here means the kernels
    changed protocol behavior."""
    import dataclasses as _dc

    from hpa2_tpu_torch.protocols.compiler import TableCompileError, planes_for

    rc = 0
    for name in args.sem:
        sem = _SEMS[name]()
        for proto in args.protocol:
            try:
                planes = planes_for(proto, sem)
            except TableCompileError as e:
                print(f"[{name}] {proto}: COMPILE FAILED: {e}")
                rc += 1
                continue
            print(f"[{name}] {proto}: "
                  f"cache states {','.join(planes.cache_state_names)} | "
                  f"home states {','.join(planes.home_state_names)} | "
                  f"digest {planes.digest()}")
            if args.verbose:
                for f in _dc.fields(planes):
                    if f.name in ("protocol", "cache_state_names",
                                  "home_state_names"):
                        continue
                    print(f"    {f.name} = {getattr(planes, f.name)}")
    return rc


def cmd_mutation_test(args: argparse.Namespace) -> int:
    from hpa2_tpu_torch.analysis.mutate import run_all_mutations

    sem = _SEMS[args.sem[0]]()
    missed = total = 0
    for protocol in ("mesi", "moesi", "mesif"):
        results = run_all_mutations(sem, protocol)
        for r in results:
            status = f"caught by {r.caught_by}" if r.caught else "MISSED"
            print(f"[{protocol}] {r.name:24s} {status}")
            if args.verbose or not r.caught:
                for e in r.evidence:
                    print(f"    {e}")
            missed += 0 if r.caught else 1
        total += len(results)
    print(f"{total - missed}/{total} mutations caught")
    return 1 if missed else 0


def main(argv=None) -> int:
    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p = argparse.ArgumentParser(prog="python -m hpa2_tpu_torch.analysis")
    p.add_argument("--sem", default="default,robust",
                   help="comma-separated semantics variants "
                        "(default,robust,head)")
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("check", help="static checks + spec equivalence")
    lp = sub.add_parser(
        "lint",
        help="AST lint: host-sync, nondeterminism, dtype-drift, "
             "dtype-widening, dead-handler, interconnect-purity, "
             "hand-written-state, counter-backfill")
    lp.add_argument("--root", default=repo_root)
    cp = sub.add_parser(
        "contracts",
        help="program contracts: declarative pins on op censuses, "
             "launches, host syncs, graph captures and ptxas per engine "
             "x config point, with structural drift diffs")
    cp.add_argument("--check", action="store_true",
                    help="verify every contract point (the default)")
    cp.add_argument("--repin", action="store_true",
                    help="refresh hpa2_tpu_torch/analysis/contracts/"
                         "*.json from the current measurements (refuses "
                         "on a dirty tree outside contracts/)")
    cp.add_argument("--list", action="store_true",
                    help="list registered contract points")
    cp.add_argument("--engine", default=None,
                    help="restrict to one engine tag (xla, pallas, "
                         "serving, sharded) or contract name")
    cp.add_argument("--root", default=repo_root)
    ep = sub.add_parser("equiv", help="cross-backend table diff")
    ep.add_argument("--backends", default="spec,jax,native,pallas",
                    help="comma-separated: spec,jax,native,pallas")
    ep.add_argument("--protocol", default="mesi,moesi,mesif",
                    help="comma-separated: mesi,moesi,mesif (native/"
                         "pallas rows are extracted for mesi only)")
    ep.add_argument("--allow-missing-native", action="store_true",
                    help="skip (not fail) when the native build is "
                         "unavailable")
    sub.add_parser("mutation-test", help="analyzer self-test")
    tbl = sub.add_parser("table", help="print compiled protocol planes")
    tbl.add_argument("--protocol", default="mesi,moesi,mesif",
                     help="comma-separated: mesi,moesi,mesif")
    vp = sub.add_parser("vmem", help="Hopper CTA budget model (shared "
                        "memory a CTA, CTAs an SM, plane bytes)")
    vp.add_argument("--blocks", default="512,1024,2048",
                    help="comma-separated block widths")
    vp.add_argument("--window", type=int, default=32)
    vp.add_argument("--procs", type=int, default=8)
    vp.add_argument("--cap", type=int, default=16,
                    help="mailbox capacity (msg_buffer_size)")
    vp.add_argument("--snapshots", action="store_true")
    vp.add_argument("--gate", action="store_true")
    vp.add_argument("--packed", action="store_true",
                    help="model the packed uint8/uint16 state planes")
    vp.add_argument("--node-shards", type=int, default=1,
                    help="model one rank of the node-sharded fast path "
                         "(its plane bytes; no CTA runs there)")
    op = sub.add_parser("occupancy", help="occupancy scheduler model")
    op.add_argument("--batch", type=int, default=64)
    op.add_argument("--instrs", type=int, default=96,
                    help="longest per-core trace (max_instrs)")
    op.add_argument("--window", type=int, default=16)
    op.add_argument("--block", type=int, default=16)
    op.add_argument("--dists", default="uniform,zipf",
                    help="comma-separated: uniform,zipf")
    op.add_argument("--spreads", default="2,4,8",
                    help="comma-separated max/min length ratios")
    op.add_argument("--threshold", type=float, default=0.5,
                    help="compaction occupancy threshold")
    op.add_argument("--resident", type=int, default=None,
                    help="device-resident lanes (default: whole batch)")
    op.add_argument("--groups", type=int, default=1,
                    help="scheduling groups (data shards)")
    op.add_argument("--seed", type=int, default=0)
    op.add_argument("--host-barriers", action="store_true",
                    help="model the PR-5 one-launch-per-interval host "
                         "loop instead of the fused single-program run")
    op.add_argument("--policy", default="fcfs",
                    help="comma-separated admission policies to "
                         "compare (fcfs,longest-first) — one table "
                         "row per policy")
    lp2 = sub.add_parser("elision", help="event-driven cycle-elision "
                         "model (exact replay vs device counters)")
    lp2.add_argument("--procs", type=int, default=4)
    lp2.add_argument("--instrs", type=int, default=400,
                     help="per-core trace length")
    lp2.add_argument("--spreads", default="2,4,8",
                     help="comma-separated Zipf hot-set spreads")
    lp2.add_argument("--tail", type=float, default=0.01,
                     help="uniform-random miss-traffic fraction")
    lp2.add_argument("--write-frac", type=float, default=0.3)
    lp2.add_argument("--seed", type=int, default=3)
    lp2.add_argument("--topology", default="ideal",
                     help="interconnect topology for the modeled run")
    lp2.add_argument("--no-verify", action="store_true",
                     help="model only; skip the device cross-check")
    tp = sub.add_parser("topology", help="interconnect sensitivity "
                        "(invalidation-storm cost per topology)")
    tp.add_argument("--nodes", type=int, default=8)
    tp.add_argument("--rounds", type=int, default=6,
                    help="storm rounds (each: all-read then one write)")
    tp.add_argument("--hop-latency", type=int, default=1)
    tp.add_argument("--bandwidth", type=int, default=1,
                    help="messages per link per cycle")
    tp.add_argument("--topologies", default="mesh2d,torus2d,hierarchical")
    for sp in (ep, cp, vp, lp2):
        sp.add_argument("--device", default="cuda",
                        help="run on cuda (the default; raises without "
                             "a GPU) or cpu (the kernels' plain "
                             "versions)")
    args = p.parse_args(argv)
    args.sem = [s.strip() for s in args.sem.split(",") if s.strip()]
    for s in args.sem:
        if s not in _SEMS:
            p.error(f"unknown semantics variant {s!r}")
    if getattr(args, "cmd", None) in ("table", "equiv"):
        args.protocol = [x.strip() for x in args.protocol.split(",")
                         if x.strip()]
        for x in args.protocol:
            if x not in ("mesi", "moesi", "mesif"):
                p.error(f"unknown protocol {x!r}")
    if hasattr(args, "backends"):
        args.backends = [b.strip() for b in args.backends.split(",")]
        for b in args.backends:
            if b not in ("spec", "jax", "native", "pallas"):
                p.error(f"unknown backend {b!r}")
    return {
        "check": cmd_check,
        "lint": cmd_lint,
        "equiv": cmd_equiv,
        "mutation-test": cmd_mutation_test,
        "contracts": cmd_contracts,
        "table": cmd_table,
        "vmem": cmd_vmem,
        "occupancy": cmd_occupancy,
        "elision": cmd_elision,
        "topology": cmd_topology,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
