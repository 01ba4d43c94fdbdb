"""Command line of the port: ``run``, ``bench`` and ``serve``, with the
flag names of ``python -m hpa2_tpu.cli``.

    python -m hpa2_tpu_torch run TRACE_DIR [--out DIR] [--final-dump]
    python -m hpa2_tpu_torch run TRACE_DIR --protocol moesi \
        --topology mesh2d --multicast --fault-drop 0.2 [--replay ORDER]
    python -m hpa2_tpu_torch bench --batch 4096 --instrs 128 --seed 0
    python -m hpa2_tpu_torch bench --backend pallas --batch 32768 \
        --instrs 128 --nodes 8 --msg-buffer-size 16 --robust --block 512 \
        --trace-window 32 --trace-len-dist zipf --schedule-resident 8192
    python -m hpa2_tpu_torch serve JOBS.jsonl --nodes 8 --robust --out DIR
    python -m hpa2_tpu_torch serve --listen 127.0.0.1:7000 --wire

``run`` simulates one system from ``core_<n>.txt`` traces and writes
``core_<n>_output.txt`` dumps (at local completion, or of the final
state with ``--final-dump``), byte-identical to
``python -m hpa2_tpu.cli run`` with the same ``--backend``.  ``bench``
times random workloads and prints one JSON line.  ``--backend jax``
(the default, as in the JAX CLI) runs the general engine
(``ops/engine.py``): every protocol, directory format, topology and
link fault, cycle elision, ``run --replay`` and the stall watchdog;
``bench`` runs one system on ``TorchEngine``, or with ``--batch > 1``
the batch loop of ``BatchTorchEngine`` on ``bench.py``'s uniform
arrays, and prints the JAX CLI's keys.  ``--backend pallas`` runs the
fast path (``CudaEngine``: MESI, full directory, ideal topology, no
faults); its ``bench`` takes an ensemble (``snapshots=False``, as
``bench.py``), uniform or with heterogeneous per-system trace lengths,
optionally under the occupancy scheduler.  ``serve``
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

import torch

from hpa2_tpu_torch.config import (
    FaultModel, InterconnectConfig, Semantics, SystemConfig,
)


def _build_config(args) -> SystemConfig:
    """The configuration the flags ask for, refusing on the fast path
    (``--backend pallas``) what only the general engine runs, with the
    JAX CLI's checks (``hpa2_tpu/cli.py:38-158``)."""
    sem = Semantics().robust() if args.robust else Semantics()
    backend = getattr(args, "backend", "pallas")
    edge_sender = edge_receiver = -1
    if getattr(args, "fault_edge", ""):
        try:
            s, r = args.fault_edge.split(":")
            edge_sender, edge_receiver = int(s), int(r)
        except ValueError:
            raise SystemExit(
                "--fault-edge takes SENDER:RECEIVER (node ids, -1 = any)"
            )
    try:
        fault = FaultModel(
            drop=getattr(args, "fault_drop", 0.0),
            duplicate=getattr(args, "fault_dup", 0.0),
            reorder=getattr(args, "fault_reorder", 0.0),
            delay=getattr(args, "fault_delay", 0.0),
            seed=getattr(args, "fault_seed", 0),
            max_retries=getattr(args, "fault_max_retries", 64),
            edge_sender=edge_sender,
            edge_receiver=edge_receiver,
        )
        interconnect = InterconnectConfig(
            topology=getattr(args, "topology", "ideal"),
            hop_latency=getattr(args, "hop_latency", 1),
            link_bandwidth=getattr(args, "link_bandwidth", 1),
            multicast=getattr(args, "multicast", False),
            combining=getattr(args, "combining", False),
            fault=fault,
        )
    except ValueError as e:
        raise SystemExit(str(e))
    protocol = getattr(args, "protocol", "mesi")
    directory_format = getattr(args, "directory_format", "full")
    if backend == "pallas":
        if fault.enabled:
            raise SystemExit(
                "fault injection is implemented by the jax backend (the "
                "pallas kernel has no link-layer fault model)")
        if interconnect.enabled:
            raise SystemExit(
                "non-ideal topologies are implemented by the jax backend "
                "(the pallas kernel delivers every message next cycle)")
        if protocol != "mesi" or directory_format != "full":
            raise SystemExit(
                "protocol/directory-format variants are implemented by "
                "the jax backend (the pallas kernel is specialized to "
                "MESI/full-bitvector)")
    try:
        return SystemConfig(
            num_procs=args.nodes,
            cache_size=args.cache_size,
            mem_size=args.mem_size,
            msg_buffer_size=args.msg_buffer_size,
            max_instr_num=args.max_instr,
            semantics=sem,
            interconnect=interconnect,
            protocol=protocol,
            directory_format=directory_format,
        )
    except ValueError as e:
        raise SystemExit(str(e))


def _write_dumps(dumps, config, out_dir: str) -> None:
    from hpa2_tpu_torch.utils.dump import format_processor_state

    for d in dumps:
        path = os.path.join(out_dir, f"core_{d.proc_id}_output.txt")
        with open(path, "w") as fh:
            fh.write(format_processor_state(d, config))


def cmd_run(args) -> int:
    from hpa2_tpu_torch.utils.trace import (
        load_instruction_order, load_trace_dir, traces_to_arrays,
    )

    config = _build_config(args)
    out_dir = args.out or os.getcwd()
    os.makedirs(out_dir, exist_ok=True)
    traces = load_trace_dir(args.trace_dir, config)
    replay = load_instruction_order(args.replay) if args.replay else None
    t0 = time.perf_counter()
    if args.backend == "pallas":
        from hpa2_tpu_torch.ops.cuda_engine import CudaEngine

        if replay is not None:
            raise SystemExit(
                "--replay runs on the jax backend (the pallas kernel has "
                "no replay mode)")
        eng = CudaEngine(config, *traces_to_arrays(config, [traces]),
                         snapshots=not args.final_dump, device=args.device)
        eng.run(args.max_cycles)
    else:
        from hpa2_tpu_torch.ops.engine import TorchEngine

        eng = TorchEngine(config, traces, replay_order=replay,
                          max_cycles=args.max_cycles,
                          watchdog_cycles=args.watchdog_cycles,
                          device=args.device)
        eng.run()
    dt = time.perf_counter() - t0
    dumps = eng.final_dumps() if args.final_dump else eng.snapshots()
    _write_dumps(dumps, config, out_dir)
    print(
        f"[{args.backend} {args.device}] {eng.instructions} instrs, "
        f"{eng.messages} msgs, {eng.cycle} cycles, {dt:.4f}s",
        file=sys.stderr,
    )
    return 0


def _bench_jax(args, config) -> int:
    """``bench --backend jax``: the JAX CLI's bench of the general
    engine (``hpa2_tpu/cli.py:590-652``): one system on ``TorchEngine``
    (``gen_uniform_random`` traces), or a batch of ``bench.py``'s
    uniform arrays through the batch loop, a warm-up run (which on the
    card also captures the loop's CUDA graph), then the timed run."""
    from hpa2_tpu_torch.ops.layout import StallError

    for flag, value in (("--trace-len-dist", args.trace_len_dist),
                        ("--schedule-resident", args.schedule_resident),
                        ("--host-barriers", args.host_barriers)):
        if value:
            raise SystemExit(
                f"{flag} is a fast-path flag (--backend pallas); the "
                "general engine's scheduled modes are not ported yet "
                "(ROADMAP queue 1 item 2b)")
    if args.checkpoint_every:
        raise SystemExit(
            "--checkpoint-every/--checkpoint-dir checkpoint the batch "
            "state, which the port does not do yet (ROADMAP queue 1 "
            "item 3, checkpoints then recovery)")
    if args.batch > 1:
        from hpa2_tpu_torch.ops.cuda_engine import resolve_device
        from hpa2_tpu_torch.ops.engine import build_batched_run
        from hpa2_tpu_torch.ops.state import init_state_batched
        from hpa2_tpu_torch.ops.step import quiescent
        from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

        dev = resolve_device(args.device)
        arrays = gen_uniform_random_arrays(config, args.batch, args.instrs,
                                           seed=args.seed)
        state = init_state_batched(config, *arrays, device=dev)
        run = build_batched_run(config, max_cycles=args.max_cycles)
        run(state)  # warm-up (captures the loop's graph on the card)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(state)  # ends in the loop's last host read
        dt = time.perf_counter() - t0
        if bool(out.overflow.any()) or not bool(quiescent(out).all()):
            raise StallError("batch did not reach quiescence")
        instrs = int(out.n_instr.sum())
    else:
        from hpa2_tpu_torch.ops.engine import TorchEngine
        from hpa2_tpu_torch.utils.trace import gen_uniform_random

        traces = gen_uniform_random(config, args.instrs, seed=args.seed)
        kw = dict(max_cycles=args.max_cycles,
                  watchdog_cycles=args.watchdog_cycles, device=args.device)
        TorchEngine(config, traces, **kw).run()
        eng = TorchEngine(config, traces, **kw)
        t0 = time.perf_counter()
        eng.run()
        dt = time.perf_counter() - t0
        instrs = eng.instructions
        dev = eng.device
    print(json.dumps({
        "backend": "jax",
        "workload": "uniform",
        "nodes": config.num_procs,
        "batch": args.batch,
        "node_shards": 1,
        "data_shards": 1,
        "instrs": instrs,
        "resumed_instrs": 0,
        "seconds": round(dt, 4),
        "ops_per_sec": round(instrs / dt, 1),
        "device": dev.type,
    }))
    return 0


def cmd_bench(args) -> int:
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
    from hpa2_tpu_torch.ops.schedule import Schedule
    from hpa2_tpu_torch.utils.trace import (
        gen_heterogeneous_random_arrays, gen_uniform_random_arrays,
    )

    config = _build_config(args)
    if args.backend == "jax":
        return _bench_jax(args, config)
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
            "serve --backend jax needs the general engine's serving "
            "session (BatchServingSession), which the port does not have "
            "yet (ROADMAP queue 1 item 2b)")
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
        help="cuda runs on the GPU (the fast path launches its kernel); "
        "cpu runs the same path on the CPU (the kernel's plain PyTorch "
        "version)",
    )
    p.add_argument(
        "--protocol", default="mesi", choices=("mesi", "moesi", "mesif"),
        help="coherence protocol variant, compiled from its "
        "TransitionTable (hpa2_tpu_torch/protocols/); moesi/mesif run "
        "on the jax backend",
    )
    p.add_argument(
        "--directory-format", default="full", metavar="FMT",
        help="directory sharer representation: 'full' (exact "
        "bitvector), 'limited:K' (K pointers, overflow -> broadcast), "
        "'coarse:G' (G-node groups); non-full formats run on the jax "
        "backend",
    )
    fg = p.add_argument_group(
        "fault injection (jax backend; faults are masked by link-layer "
        "retry, so dumps stay byte-identical to a fault-free run unless "
        "a link is fully severed)"
    )
    fg.add_argument("--fault-drop", type=float, default=0.0, metavar="P",
                    help="per-hop drop probability (dropped copies are "
                    "retransmitted in-cycle, up to --fault-max-retries)")
    fg.add_argument("--fault-dup", type=float, default=0.0, metavar="P",
                    help="per-delivery duplicate probability (filtered; "
                    "counted in stats)")
    fg.add_argument("--fault-reorder", type=float, default=0.0,
                    metavar="P",
                    help="per-delivery reorder probability (reassembled; "
                    "counted in stats)")
    fg.add_argument("--fault-delay", type=float, default=0.0, metavar="P",
                    help="per-delivery extra-latency probability "
                    "(absorbed in the delivery cycle; counted in stats)")
    fg.add_argument("--fault-seed", type=int, default=0)
    fg.add_argument("--fault-max-retries", type=int, default=64,
                    help="in-cycle retransmission budget per message; "
                    "exhaustion defers the send to the next cycle")
    fg.add_argument("--fault-edge", default="", metavar="S:R",
                    help="restrict faults to the directed link S->R "
                    "(-1 = any); --fault-drop 1.0 --fault-edge 1:0 "
                    "severs one link to exercise the watchdog")
    tg = p.add_argument_group(
        "interconnect topology (jax backend; 'ideal' delivers every "
        "message next cycle)"
    )
    tg.add_argument("--topology", default="ideal",
                    choices=("ideal", "mesh2d", "torus2d", "hierarchical"),
                    help="per-message delivery delay: base hop latency "
                    "along the routed path plus per-link queueing under "
                    "finite bandwidth")
    tg.add_argument("--hop-latency", type=int, default=1, metavar="CYC",
                    help="cycles per hop (the DCN tier of 'hierarchical' "
                    "costs 4x)")
    tg.add_argument("--link-bandwidth", type=int, default=1,
                    metavar="MSGS",
                    help="messages per link per cycle before queueing "
                    "delay accrues")
    tg.add_argument("--multicast", action="store_true",
                    help="invalidation fan-outs traverse each shared "
                    "path link once")
    tg.add_argument("--combining", action="store_true",
                    help="same-address read requests merge in-network")
    p.add_argument(
        "--watchdog-cycles", type=int, default=10_000, metavar="K",
        help="jax backend: raise a StallDiagnostic when no instruction "
        "retires and no mailbox drains for K cycles (0 disables)",
    )


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="hpa2_tpu_torch",
        description="directory-MESI DSM simulator, PyTorch/CUDA fast path",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("run", help="run a trace directory, write dumps")
    rp.add_argument("trace_dir")
    rp.add_argument(
        "--backend", choices=("pallas", "jax"), default="jax",
        help="jax = the general engine (every protocol, directory "
        "format, topology and fault); pallas = the fast path",
    )
    rp.add_argument("--out", help="output directory (default: CWD)")
    rp.add_argument(
        "--replay", default=None,
        help="jax backend: instruction_order.txt to replay",
    )
    rp.add_argument(
        "--final-dump", action="store_true",
        help="dump final quiescent state instead of at local completion",
    )
    _add_common(rp)
    rp.set_defaults(fn=cmd_run)

    bp = sub.add_parser("bench", help="synthetic benchmark, JSON result")
    bp.add_argument(
        "--backend", choices=("pallas", "jax"), default="jax",
        help="jax = the general engine; pallas = the fast path (the "
        "--block, --trace-window, --cycles-per-call, --trace-len-* and "
        "--schedule-* flags are its own)",
    )
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
    bp.add_argument(
        "--checkpoint-every", type=int, default=0, metavar="CYCLES",
        help="jax backend with --batch > 1: refused until the port "
        "checkpoints (ROADMAP queue 1 item 3)",
    )
    bp.add_argument("--checkpoint-dir", default="hpa2_ckpt")
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
        "serving backend); jax is refused until the port has the "
        "general engine's serving session (ROADMAP queue 1 item 2b)",
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
