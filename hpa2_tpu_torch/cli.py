"""Command line of the port: ``run``, ``bench`` and ``serve`` on the
fast path, with the flag names of ``python -m hpa2_tpu.cli``.

    python -m hpa2_tpu_torch run TRACE_DIR [--out DIR] [--final-dump]
    python -m hpa2_tpu_torch bench --batch 4096 --instrs 128 --seed 0
    python -m hpa2_tpu_torch bench --batch 32768 --instrs 128 --nodes 8 \
        --msg-buffer-size 16 --robust --block 512 --trace-window 32 \
        --trace-len-dist zipf --schedule-resident 8192 [--host-barriers]
    python -m hpa2_tpu_torch serve JOBS.jsonl --nodes 8 --robust --out DIR
    python -m hpa2_tpu_torch serve --listen 127.0.0.1:7000 --wire

``run`` simulates one system from ``core_<n>.txt`` traces and writes
``core_<n>_output.txt`` dumps (at local completion, or of the final
state with ``--final-dump``), byte-identical to
``python -m hpa2_tpu.cli run --backend pallas``.  ``bench`` times an
ensemble of random workloads (``snapshots=False``, as ``bench.py``),
uniform or with heterogeneous per-system trace lengths, optionally
under the occupancy scheduler, and prints one JSON line.  ``serve``
admits a JSONL job feed (a file, or TCP with ``--listen``, framed with
``--wire``) into resident lanes, writes each job's dumps as it retires
and prints the serving stats as its last line, as
``python -m hpa2_tpu.cli serve`` does on its ``pallas`` backend.  All
run on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from hpa2_tpu_torch.config import Semantics, SystemConfig


def _build_config(args) -> SystemConfig:
    sem = Semantics().robust() if args.robust else Semantics()
    return SystemConfig(
        num_procs=args.nodes,
        cache_size=args.cache_size,
        mem_size=args.mem_size,
        msg_buffer_size=args.msg_buffer_size,
        max_instr_num=args.max_instr,
        semantics=sem,
    )


def _write_dumps(dumps, config, out_dir: str) -> None:
    from hpa2_tpu_torch.utils.dump import format_processor_state

    for d in dumps:
        path = os.path.join(out_dir, f"core_{d.proc_id}_output.txt")
        with open(path, "w") as fh:
            fh.write(format_processor_state(d, config))


def cmd_run(args) -> int:
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
    from hpa2_tpu_torch.utils.trace import load_trace_dir, traces_to_arrays

    config = _build_config(args)
    out_dir = args.out or os.getcwd()
    os.makedirs(out_dir, exist_ok=True)
    traces = load_trace_dir(args.trace_dir, config)
    t0 = time.perf_counter()
    eng = CudaEngine(config, *traces_to_arrays(config, [traces]),
                     snapshots=not args.final_dump, device=args.device)
    eng.run(args.max_cycles)
    dt = time.perf_counter() - t0
    dumps = eng.final_dumps() if args.final_dump else eng.snapshots()
    _write_dumps(dumps, config, out_dir)
    print(
        f"[{args.device}] {eng.instructions} instrs, {eng.messages} msgs, "
        f"{eng.cycle} cycles, {dt:.4f}s",
        file=sys.stderr,
    )
    return 0


def cmd_bench(args) -> int:
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
    from hpa2_tpu_torch.ops.schedule import Schedule
    from hpa2_tpu_torch.utils.trace import (
        gen_heterogeneous_random_arrays, gen_uniform_random_arrays,
    )

    config = _build_config(args)
    if args.trace_len_dist:
        arrays = gen_heterogeneous_random_arrays(
            config, args.batch, args.instrs, dist=args.trace_len_dist,
            spread=max(1.0, args.trace_len_spread), seed=args.seed)
    else:
        arrays = gen_uniform_random_arrays(config, args.batch, args.instrs,
                                           seed=args.seed)
    schedule = None
    if args.schedule_resident:
        schedule = Schedule(resident=min(args.schedule_resident, args.batch),
                            fused=not args.host_barriers)

    def build():
        return CudaEngine(config, *arrays, block=args.block,
                          cycles_per_call=args.cycles_per_call,
                          snapshots=False, trace_window=args.trace_window,
                          schedule=schedule, device=args.device)

    build().run(args.max_cycles)  # warm-up (builds the kernel)
    eng = build()
    t0 = time.perf_counter()
    eng.run(args.max_cycles)  # ends in the status readback
    dt = time.perf_counter() - t0
    instrs = eng.instructions
    rec = {
        "backend": "cuda" if eng.device.type == "cuda" else "cpu",
        "workload": args.trace_len_dist or "uniform",
        "nodes": config.num_procs,
        "batch": args.batch,
        "instrs": instrs,
        "seconds": round(dt, 4),
        "ops_per_sec": round(instrs / dt, 1),
    }
    if schedule is not None:
        rec["occupancy"] = eng.occupancy.as_dict()
    print(json.dumps(rec))
    return 0


def cmd_serve(args) -> int:
    config = _build_config(args)
    if args.backend == "jax":
        raise SystemExit(
            "serve --backend jax needs the XLA batch engine, which the "
            "port does not have yet (ROADMAP queue 1 item 2)")
    if args.data_shards > 1 or args.node_shards > 1:
        raise SystemExit(
            "--data-shards/--node-shards > 1 serve on several GPUs, which "
            "the port does not do yet (ROADMAP queue 1 item 4)")
    for flag, value in (("--failure-plan", args.failure_plan),
                        ("--checkpoint-dir", args.checkpoint_dir),
                        ("--migrate-to", args.migrate_to)):
        if value is not None:
            raise SystemExit(
                f"{flag} arms the recovery supervisor, which the port "
                "does not have yet (ROADMAP queue 1 item 3, checkpoints "
                "then recovery)")
    if (args.jobs is None) == (args.listen is None):
        raise SystemExit(
            "serve needs exactly one job feed: a JOBS.jsonl path or "
            "--listen HOST:PORT"
        )
    if args.wire and not args.listen:
        raise SystemExit(
            "--wire frames the TCP feed; it needs --listen HOST:PORT"
        )
    from hpa2_tpu_torch.service import TenantTable
    from hpa2_tpu_torch.serving import FileJobSource, SocketJobSource, serve

    try:
        tenants = TenantTable.parse(args.tenant_weights or "")
    except ValueError as e:
        raise SystemExit(f"--tenant-weights: {e}")

    wire_source = None
    if args.listen:
        host, _, port = args.listen.rpartition(":")
        try:
            port_n = int(port)
        except ValueError:
            raise SystemExit("--listen takes HOST:PORT")
        if args.wire:
            from hpa2_tpu_torch.service import WireJobSource

            source = wire_source = WireJobSource(
                config, host or "127.0.0.1", port_n,
                credits=args.credits, tenants=tenants,
                shed_threshold=args.shed_threshold,
                heartbeat_s=args.heartbeat,
            )
            print(
                f"[serve] framed wire on "
                f"{source.address[0]}:{source.address[1]} "
                f"({args.credits} admission credits per connection)",
                file=sys.stderr,
            )
        else:
            source = SocketJobSource(config, host or "127.0.0.1", port_n)
            print(
                f"[serve] listening on "
                f"{source.address[0]}:{source.address[1]} "
                "(JSONL job records; {\"eof\": true} ends the feed)",
                file=sys.stderr,
            )
    else:
        source = FileJobSource(config, args.jobs, timed=not args.immediate)

    out = args.out
    results_fh = (
        open(args.results_jsonl, "w") if args.results_jsonl else None
    )

    def emit(res):
        # stream each job's dumps/record the moment its lane retires
        if out:
            d = os.path.join(out, res.job_id)
            os.makedirs(d, exist_ok=True)
            _write_dumps(res.dumps, config, d)
        if results_fh:
            results_fh.write(json.dumps(res.to_record()) + "\n")
            results_fh.flush()
        if wire_source is not None:
            wire_source.deliver(res)

    try:
        _, stats = serve(
            config, source,
            backend=args.backend,
            resident=args.resident,
            window=args.window,
            block=args.block,
            policy=args.policy,
            overlap=not args.no_overlap,
            max_cycles=args.max_cycles,
            decode_dumps=bool(out),
            emit=emit,
            tenant_weights=tenants.weights or None,
            device=args.device,
        )
    finally:
        source.close()
        if results_fh:
            results_fh.close()
    print(json.dumps(stats.as_dict()))
    return 0


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--cache-size", type=int, default=4)
    p.add_argument("--mem-size", type=int, default=16)
    p.add_argument("--msg-buffer-size", type=int, default=256)
    p.add_argument(
        "--max-instr", type=int, default=32,
        help="per-core trace cap (reference MAX_INSTR_NUM)",
    )
    p.add_argument("--max-cycles", type=int, default=1_000_000)
    p.add_argument(
        "--robust", action="store_true",
        help="NACK/retry on stale interventions (sound at scale)",
    )
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="cuda launches the kernel; cpu runs its plain PyTorch version",
    )


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="hpa2_tpu_torch",
        description="directory-MESI DSM simulator, PyTorch/CUDA fast path",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("run", help="run a trace directory, write dumps")
    rp.add_argument("trace_dir")
    rp.add_argument("--out", help="output directory (default: CWD)")
    rp.add_argument(
        "--final-dump", action="store_true",
        help="dump final quiescent state instead of at local completion",
    )
    _add_common(rp)
    rp.set_defaults(fn=cmd_run)

    bp = sub.add_parser("bench", help="synthetic benchmark, JSON result")
    bp.add_argument("--instrs", type=int, default=1000)
    bp.add_argument("--batch", type=int, default=1)
    bp.add_argument("--seed", type=int, default=0)
    bp.add_argument("--block", type=int, default=1024,
                    help="lanes per lane block (one CTA)")
    bp.add_argument("--trace-window", type=int, default=None,
                    help="instructions per trace window (default: all)")
    bp.add_argument("--cycles-per-call", type=int, default=128)
    bp.add_argument(
        "--trace-len-dist", choices=("uniform", "zipf"), default=None,
        help="heterogeneous per-system trace lengths over "
             "[instrs/spread, instrs] (default: every trace --instrs long)",
    )
    bp.add_argument("--trace-len-spread", type=float, default=8.0,
                    help="longest over shortest trace length")
    bp.add_argument(
        "--schedule-resident", type=int, default=0,
        help="occupancy scheduler with this many resident lanes (0: off)",
    )
    bp.add_argument(
        "--host-barriers", action="store_true",
        help="scheduled run as one host-synced interval at a time "
             "(default: the whole plan fused on the device)",
    )
    _add_common(bp)
    bp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser(
        "serve",
        help="always-on serving: admit a continuous JSONL job feed "
        "into resident lanes without rebuilding",
    )
    sp.add_argument(
        "jobs", nargs="?", default=None,
        help="JSONL jobs file (one job per line); omit when using "
        "--listen",
    )
    sp.add_argument(
        "--listen", metavar="HOST:PORT", default=None,
        help="accept JSONL job records over TCP instead of a file; "
        "a {\"eof\": true} record ends the feed",
    )
    sp.add_argument(
        "--wire", action="store_true",
        help="with --listen: speak the framed wire protocol "
        "(hpa2_tpu_torch/service/): every SUBMIT is ACK'd with its "
        "admission seq or NACK'd with a reason, results stream back to "
        "the submitting connection, and overload pushes back via "
        "admission credits",
    )
    sp.add_argument(
        "--credits", type=int, default=64,
        help="--wire: admission credits per connection",
    )
    sp.add_argument(
        "--tenant-weights", default=None, metavar="NAME:W,...",
        help="fair-share weights for --policy fair-drr (e.g. "
        "'alice:4,bob:1'; unlisted tenants weigh 1.0)",
    )
    sp.add_argument(
        "--backend", choices=("pallas", "jax"), default="pallas",
        help="pallas = the resident-lane fast path (the port's only "
        "serving backend); jax is refused until the port has the XLA "
        "batch engine",
    )
    sp.add_argument("--data-shards", type=int, default=1,
                    help="refused above 1 (no multi-GPU serving yet)")
    sp.add_argument("--node-shards", type=int, default=1,
                    help="refused above 1 (no multi-GPU serving yet)")
    sp.add_argument(
        "--resident", type=int, default=16,
        help="device-resident lanes (the fixed serving shape)",
    )
    sp.add_argument("--window", type=int, default=16,
                    help="trace-window segment length")
    sp.add_argument("--block", type=int, default=1024,
                    help="lane block width (clamped to resident)")
    sp.add_argument(
        "--policy", default="fcfs",
        choices=("fcfs", "longest-first", "deadline-edf", "fair-drr"),
        help="admission queue order at segment barriers",
    )
    sp.add_argument(
        "--immediate", action="store_true",
        help="ignore per-job arrival offsets; release the whole jobs "
        "file at once (deterministic replay mode)",
    )
    sp.add_argument(
        "--no-overlap", action="store_true",
        help="wait for the device after every launch instead of "
        "pipelining host staging one interval ahead (the serial "
        "baseline)",
    )
    sp.add_argument(
        "--out", default=None,
        help="write each job's dumps to OUT/<job-id>/"
        "core_<n>_output.txt as its lane retires",
    )
    sp.add_argument(
        "--results-jsonl", default=None, metavar="PATH",
        help="stream one JSON result record (latency, counters) per "
        "completed job",
    )
    sp.add_argument(
        "--shed-threshold", type=int, default=0, metavar="N",
        help="--wire: once N jobs are pending, batch-class SUBMITs draw "
        "a structured 'shed' NACK instead of queueing",
    )
    sp.add_argument(
        "--heartbeat", type=float, default=0.0, metavar="SECS",
        help="--wire: HEARTBEAT frames to idle connections every SECS",
    )
    fp = sp.add_argument_group(
        "fault tolerance (refused: the recovery supervisor is not "
        "ported yet)")
    fp.add_argument("--failure-plan", default=None, metavar="SPEC")
    fp.add_argument("--migrate-to", default=None, metavar="B[:D[:N]],...")
    fp.add_argument("--checkpoint-dir", default=None, metavar="DIR")
    _add_common(sp)
    sp.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
