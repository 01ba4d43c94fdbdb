"""Command line of the port: ``run``, ``bench`` and ``serve``, with the
flags, backends, messages and JSON keys of ``python -m hpa2_tpu.cli``.

    python -m hpa2_tpu_torch run TRACE_DIR [--out DIR] [--final-dump]
    python -m hpa2_tpu_torch run TRACE_DIR --protocol moesi \
        --topology mesh2d --multicast --fault-drop 0.2 [--replay ORDER]
    python -m hpa2_tpu_torch run TRACE_DIR --backend spec \
        --record-order ORDER --trace-msgs MSGS [--crash-at 40]
    python -m hpa2_tpu_torch run TRACE_DIR --backend omp [--free-running]
    python -m hpa2_tpu_torch run TRACE_DIR --backend pallas \
        --quirks eager-write,flush-old-fill
    python -m hpa2_tpu_torch bench --batch 4096 --instrs 128 --seed 0
    python -m hpa2_tpu_torch bench --backend pallas --batch 4096 \
        --instrs 128 --nodes 8 --workload producer-consumer
    python -m hpa2_tpu_torch bench --backend pallas --batch 32768 \
        --instrs 128 --nodes 8 --msg-buffer-size 16 --robust --block 512 \
        --trace-window 32 --trace-len-dist zipf --schedule-resident 8192
    python -m hpa2_tpu_torch bench --backend omp --nodes 8 --instrs 50000
    python -m hpa2_tpu_torch bench --batch 1024 --instrs 128 \
        --checkpoint-every 128 --checkpoint-dir CKPT
    python -m hpa2_tpu_torch serve JOBS.jsonl --nodes 8 --robust --out DIR
    python -m hpa2_tpu_torch serve JOBS.jsonl --backend jax --interval 256
    python -m hpa2_tpu_torch serve JOBS.jsonl --failure-plan kill@3 \
        --checkpoint-dir CKPT
    python -m hpa2_tpu_torch serve --listen 127.0.0.1:7000 --wire

``run`` simulates one system from ``core_<n>.txt`` traces and writes
``core_<n>_output.txt`` dumps (at local completion, or of the final
state with ``--final-dump``), byte-identical to
``python -m hpa2_tpu.cli run`` with the same flags.  ``bench`` times a
``--workload`` (uniform, producer-consumer, local) and prints one JSON
line with the JAX CLI's keys.  The backends:

* ``jax`` (the default, as in the JAX CLI): the general engine
  (``ops/engine.py``): every protocol, directory format, topology and
  link fault, cycle elision, ``--replay`` and the stall watchdog;
  ``bench`` runs one system on ``TorchEngine`` or, with ``--batch >
  1``, the batch loop of ``BatchTorchEngine`` (with
  ``--checkpoint-every`` in chunks, a checkpoint after each and resumed
  from the newest).
* ``pallas``: the fast path (``CudaEngine``: MESI, full directory,
  ideal topology, no faults, the two value quirks); its ``bench`` takes
  an ensemble (``snapshots=False``, as ``bench.py``), optionally with
  heterogeneous per-system trace lengths under the occupancy scheduler.
* ``spec``: the executable spec (``models/spec_engine.py``), with
  ``--messages-per-cycle``, ``--trace-msgs``, ``--record-order`` and
  ``--crash-at``/``--resume`` (JSON checkpoints of either package).
* ``omp``: the C++/OpenMP engine of ``native/`` (``native.py``, built
  into ``hpa2_tpu_torch/build/native/``), lockstep or
  ``--free-running``.

``--head-quirks`` and ``--quirks`` switch the reference HEAD's
divergences on (``overloaded-notify`` on ``spec``/``omp`` only).
``serve`` admits a JSONL job feed (a file, or TCP with ``--listen``,
framed with ``--wire``) into resident lanes (``--backend pallas``, the
default) or rows of the general engine (``--backend jax``), writes each
job's dumps as it retires and prints the serving stats as its last
line, as ``python -m hpa2_tpu.cli serve`` does; ``--failure-plan`` or
``--checkpoint-dir`` put the recovery supervisor around it.  ``jax``
and ``pallas`` run on the GPU unless ``--device cpu`` is given;
``spec`` and ``omp`` run on the host.  ``--data-shards`` splits an
ensemble over the cards (``bench`` and ``serve``; ``parallel/``), and
``--node-shards`` splits a system's nodes over ranks of one card each
(``run``/``bench`` with ``--backend jax`` or ``pallas``, ``serve``;
``--exchange-mode``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import List, Optional

import torch

from hpa2_tpu_torch.config import (
    FaultModel, InterconnectConfig, Semantics, SystemConfig,
)


_QUIRK_FIELDS = {
    "eager-write": "eager_write_request_memory",
    "flush-old-fill": "flush_invack_fills_old_value",
    "overloaded-notify": "overloaded_evict_shared_notify",
}


def _build_config(args) -> SystemConfig:
    """The configuration the flags ask for, refusing what the chosen
    backend does not implement, with the JAX CLI's checks and messages
    (``hpa2_tpu/cli.py:38-147``): the head quirks (``overloaded-notify``
    only on ``spec``/``omp``), ``--messages-per-cycle`` only on
    ``spec``, faults only on ``spec``/``jax``, non-ideal topologies and
    protocol or directory variants not on ``pallas``/``omp``."""
    sem = Semantics()
    if getattr(args, "head_quirks", False):
        sem = sem.head_quirks()
    quirks = getattr(args, "quirks", "")
    for name in quirks.split(",") if quirks else []:
        field = _QUIRK_FIELDS.get(name.strip())
        if field is None:
            raise SystemExit(
                f"unknown quirk {name.strip()!r}; choose from "
                + ", ".join(sorted(_QUIRK_FIELDS))
            )
        sem = dataclasses.replace(sem, **{field: True})
    backend = getattr(args, "backend", "pallas")
    if sem.overloaded_evict_shared_notify and backend in ("jax", "pallas"):
        raise SystemExit(
            "the overloaded-notify quirk is implemented by the spec and "
            "omp backends only; the jax/pallas engines support the "
            "eager-write and flush-old-fill quirks "
            "(--quirks eager-write,flush-old-fill)"
        )
    if args.robust:
        sem = sem.robust()
    k = getattr(args, "messages_per_cycle", 1)
    if k != 1 and backend != "spec":
        raise SystemExit(
            "--messages-per-cycle > 1 is a spec-engine schedule knob "
            "(PERF.md lever 4); the other backends drain one message "
            "per node per cycle"
        )
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
    if fault.enabled and backend in ("pallas", "omp"):
        raise SystemExit(
            "fault injection is implemented by the spec and jax "
            "backends (the pallas kernel and the native engine have "
            "no link-layer fault model)"
        )
    if interconnect.enabled and backend not in ("spec", "jax"):
        raise SystemExit(
            "non-ideal topologies are implemented by the spec and "
            "jax backends (the pallas kernel and the native engine "
            "deliver every message next cycle)"
        )
    if interconnect.enabled and getattr(args, "node_shards", 1) != 1:
        raise SystemExit(
            "non-ideal topologies run single-shard only; "
            "--node-shards composes with --topology ideal"
        )
    protocol = getattr(args, "protocol", "mesi")
    directory_format = getattr(args, "directory_format", "full")
    if (protocol != "mesi" or directory_format != "full") \
            and backend in ("pallas", "omp"):
        raise SystemExit(
            "protocol/directory-format variants are implemented by "
            "the spec and jax backends (the pallas kernel and the "
            "native engine are specialized to MESI/full-bitvector)"
        )
    if (protocol != "mesi" or directory_format != "full") \
            and getattr(args, "node_shards", 1) != 1:
        raise SystemExit(
            "--node-shards runs the MESI/full-bitvector build only; "
            "protocol variants compose with single-shard jax/spec"
        )
    try:
        return SystemConfig(
            num_procs=args.nodes,
            cache_size=args.cache_size,
            mem_size=args.mem_size,
            msg_buffer_size=args.msg_buffer_size,
            max_instr_num=args.max_instr,
            messages_per_cycle=k,
            semantics=sem,
            interconnect=interconnect,
            protocol=protocol,
            directory_format=directory_format,
            exchange_mode=getattr(args, "exchange_mode", "a2a"),
            exchange_inner=getattr(args, "exchange_inner", 0),
        )
    except ValueError as e:
        raise SystemExit(str(e))


def _check_shard_args(args) -> None:
    """The JAX CLI's shard checks (``hpa2_tpu/cli.py:162-176``)."""
    if (args.node_shards > 1 or args.data_shards > 1) \
            and args.backend not in ("jax", "pallas"):
        raise SystemExit(
            "--node-shards/--data-shards are jax/pallas-backend "
            "features (device-mesh sharding; the omp/spec backends "
            "are single-host)"
        )
    if args.node_shards > 1 and args.nodes % args.node_shards != 0:
        raise SystemExit(
            f"--node-shards {args.node_shards} must divide --nodes "
            f"{args.nodes} (shards own contiguous equal node blocks)"
        )


def _write_dumps(dumps, config, out_dir: str) -> None:
    from hpa2_tpu_torch.utils.dump import format_processor_state

    for d in dumps:
        path = os.path.join(out_dir, f"core_{d.proc_id}_output.txt")
        with open(path, "w") as fh:
            fh.write(format_processor_state(d, config))


def cmd_run(args) -> int:
    """``run``: one system from a trace directory, dumps into ``--out``,
    with the JAX CLI's backends (``hpa2_tpu/cli.py:178-347``).  ``spec``
    and ``omp`` are host engines (``--device`` does not apply to them);
    ``jax`` and ``pallas`` run on ``--device``."""
    from hpa2_tpu_torch.utils.trace import (
        load_instruction_order, load_trace_dir, traces_to_arrays,
    )

    config = _build_config(args)
    _check_shard_args(args)
    if (args.crash_at or args.resume) and args.backend != "spec":
        raise SystemExit(
            "--crash-at/--resume checkpoint the spec engine's Python "
            "state (the jax bench path has its own --checkpoint-every)"
        )
    if args.data_shards > 1:
        raise SystemExit(
            "--data-shards applies to bench (--batch > 1 ensembles); "
            "run simulates one system"
        )
    out_dir = args.out or os.getcwd()
    os.makedirs(out_dir, exist_ok=True)

    if args.backend == "omp":
        from hpa2_tpu_torch import native

        res = native.run_trace_dir(
            config,
            args.trace_dir,
            out_dir,
            mode="omp" if args.free_running else "lockstep",
            replay_path=args.replay,
            final_dump=args.final_dump,
            max_cycles=args.max_cycles,
            record_order_path=args.record_order,
            msg_trace_path=args.trace_msgs,
        )
        print(
            f"[omp] {res.instructions} instrs, {res.messages} msgs, "
            f"{res.seconds:.4f}s",
            file=sys.stderr,
        )
        return 0

    # a --resume checkpoint carries its own traces; trace_dir is unused
    traces = None if args.resume else load_trace_dir(args.trace_dir, config)
    replay = load_instruction_order(args.replay) if args.replay else None
    tag = args.backend
    t0 = time.perf_counter()
    if args.backend == "spec":
        from hpa2_tpu_torch.models.spec_engine import SpecEngine
        from hpa2_tpu_torch.utils.checkpoint import (
            load_spec_state, save_spec_state,
        )

        if args.resume:
            eng = load_spec_state(args.resume)
            config = eng.config  # the checkpoint's config wins
            print(f"resumed from {args.resume} at cycle {eng.cycle}",
                  file=sys.stderr)
        else:
            eng = SpecEngine(config, traces, replay_order=replay,
                             trace_msgs=bool(args.trace_msgs))
        if args.crash_at:
            # a mid-run crash: advance to the cycle, persist, exit; a
            # later --resume run finishes byte-identically
            while eng.cycle < args.crash_at and not (
                eng.quiescent() and all(n.dumped for n in eng.nodes)
            ):
                eng.step()
            save_spec_state(args.crash_checkpoint, eng)
            print(
                f"checkpointed at cycle {eng.cycle} -> "
                f"{args.crash_checkpoint} (resume with --resume)",
                file=sys.stderr,
            )
            return 0
        eng.run(max_cycles=args.max_cycles,
                watchdog_cycles=args.watchdog_cycles)
        if args.trace_msgs:
            with open(args.trace_msgs, "w") as f:
                f.writelines(line + "\n" for line in eng.msg_log)
        if args.record_order:
            from hpa2_tpu_torch.utils.trace import format_instruction_order

            with open(args.record_order, "w") as f:
                f.write(format_instruction_order(eng.issue_log))
    else:
        if args.trace_msgs:
            raise SystemExit(
                "--trace-msgs is supported by the spec and omp "
                "backends (the jax engines run entirely on device)"
            )
        if args.record_order:
            raise SystemExit(
                "--record-order is supported by the spec and omp "
                "backends (the jax backend runs entirely on device; "
                "its deterministic schedule is identical to the spec "
                "engine's, so record there)"
            )
        tag = f"{args.backend} {args.device}"
        if args.backend == "pallas":
            from hpa2_tpu_torch.ops.cuda_engine import CudaEngine

            if replay is not None:
                raise SystemExit(
                    "--replay runs on the spec/jax/omp lockstep "
                    "engines (the pallas kernel has no replay mode)"
                )
            if args.node_shards > 1:
                # one system's node axis over ranks; delivery is the
                # targeted cross-shard exchange, bit-identical to the
                # one-card kernel
                from hpa2_tpu_torch.parallel import NodeShardedCudaEngine

                eng = NodeShardedCudaEngine(
                    config, *traces_to_arrays(config, [traces]),
                    node_shards=args.node_shards,
                    snapshots=not args.final_dump, device=args.device)
            else:
                eng = CudaEngine(config,
                                 *traces_to_arrays(config, [traces]),
                                 snapshots=not args.final_dump,
                                 device=args.device)
            eng.run(args.max_cycles)
        elif args.node_shards > 1:
            # the node axis over ranks (one card each), bit-identical
            # to the single-device engine
            from hpa2_tpu_torch.parallel import NodeShardedEngine, make_mesh

            if replay is not None:
                raise SystemExit(
                    "--replay is single-shard only (fixture replays "
                    "are tiny 4-node systems)"
                )
            eng = NodeShardedEngine(
                config, traces,
                mesh=make_mesh(node_shards=args.node_shards, data_shards=1,
                               device=args.device),
                max_cycles=args.max_cycles,
                watchdog_cycles=args.watchdog_cycles)
            eng.run()
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
        f"[{tag}] {eng.instructions} instrs, {eng.messages} msgs, "
        f"{eng.cycle} cycles, {dt:.4f}s",
        file=sys.stderr,
    )
    return 0


def _workload_arrays(args, config):
    """``--workload``'s ``[B, N, T]`` arrays: ``bench.py``'s uniform
    arrays, or one Python trace list per system (seed + system index)
    packed into arrays, as the JAX CLI builds them
    (``hpa2_tpu/cli.py:409-420``)."""
    from hpa2_tpu_torch.utils.trace import (
        gen_uniform_random_arrays, traces_to_arrays,
    )

    if args.workload == "uniform":
        return gen_uniform_random_arrays(config, args.batch, args.instrs,
                                         seed=args.seed)
    gen = _generator(args.workload)
    return traces_to_arrays(
        config, [gen(config, args.instrs, seed=args.seed + b)
                 for b in range(args.batch)])


def _generator(workload: str):
    """The per-system trace generator of ``--workload``."""
    from hpa2_tpu_torch.utils import trace

    return {"uniform": trace.gen_uniform_random,
            "producer-consumer": trace.gen_producer_consumer,
            "local": trace.gen_local_only}[workload]


def _bench_line(args, config, instrs, dt, resumed_instrs=0, **extra):
    """The JAX CLI's bench keys (``hpa2_tpu/cli.py:614-629``), then
    ``extra`` (the port's ``device``, a scheduled run's occupancy)."""
    print(json.dumps({
        "backend": args.backend,
        "workload": args.workload,
        "nodes": config.num_procs,
        "batch": args.batch,
        "node_shards": args.node_shards,
        "data_shards": args.data_shards,
        "instrs": instrs,
        "resumed_instrs": resumed_instrs,
        "seconds": round(dt, 4),
        "ops_per_sec": round(instrs / dt, 1),
        **extra,
    }))
    return 0


def _bench_host(args, config) -> int:
    """``bench --backend spec|omp``: the host engines, one system
    (``hpa2_tpu/cli.py:371-401``)."""
    if args.backend == "spec":
        # the executable spec: not a performance path, but the
        # reference point for schedule experiments (--messages-per-cycle)
        if args.batch > 1:
            raise SystemExit("the spec backend benchmarks batch 1 only")
        from hpa2_tpu_torch.models.spec_engine import SpecEngine

        traces = _generator(args.workload)(config, args.instrs,
                                           seed=args.seed)
        eng = SpecEngine(config, traces)
        t0 = time.perf_counter()
        eng.run(max_cycles=args.max_cycles,
                watchdog_cycles=args.watchdog_cycles)
        dt = time.perf_counter() - t0
        instrs = eng.instructions
        print(f"[spec] {eng.cycle} cycles", file=sys.stderr)
    else:
        if args.workload != "uniform" or args.batch > 1:
            raise SystemExit(
                "the omp backend benchmarks the uniform workload at "
                "batch 1 only (native trace generation)"
            )
        from hpa2_tpu_torch import native

        res = native.bench_random(
            config, instrs_per_core=args.instrs, seed=args.seed,
            mode="omp" if args.free_running else "lockstep")
        instrs, dt = int(res.instructions), float(res.seconds)
    return _bench_line(args, config, instrs, dt)


def _bench_jax(args, config) -> int:
    """``bench --backend jax``: the JAX CLI's bench of the general
    engine (``hpa2_tpu/cli.py:479-612``): one system on ``TorchEngine``
    (``--workload``'s generator), or a batch of ``--workload``'s arrays
    through the batch loop, a warm-up run (which on the card also
    captures the loop's CUDA graph), then the timed run; with
    ``--checkpoint-every`` the chunked advance of :func:`_bench_chunked`
    instead."""
    from hpa2_tpu_torch.models.spec_engine import StallError

    for flag, value in (("--trace-len-dist", args.trace_len_dist),
                        ("--schedule-resident", args.schedule_resident),
                        ("--host-barriers", args.host_barriers)):
        if value:
            raise SystemExit(
                f"{flag} is a fast-path flag: it runs with --backend "
                "pallas (the general engine's bench, as the JAX CLI's, "
                "has no scheduled mode)")
    if args.node_shards > 1 or args.data_shards > 1:
        return _bench_sharded(args, config)
    resumed_instrs = 0  # nonzero only when a checkpointed run resumes
    if args.batch > 1 and args.checkpoint_every:
        dev, out, dt, resumed_instrs = _bench_chunked(args, config)
        instrs = int(out.n_instr.sum()) - resumed_instrs
    elif args.batch > 1:
        from hpa2_tpu_torch.ops.cuda_engine import resolve_device
        from hpa2_tpu_torch.ops.engine import build_batched_run
        from hpa2_tpu_torch.ops.state import init_state_batched
        from hpa2_tpu_torch.ops.step import quiescent

        dev = resolve_device(args.device)
        state = init_state_batched(config, *_workload_arrays(args, config),
                                   device=dev)
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

        traces = _generator(args.workload)(config, args.instrs,
                                           seed=args.seed)
        kw = dict(max_cycles=args.max_cycles,
                  watchdog_cycles=args.watchdog_cycles, device=args.device)
        TorchEngine(config, traces, **kw).run()
        eng = TorchEngine(config, traces, **kw)
        t0 = time.perf_counter()
        eng.run()
        dt = time.perf_counter() - t0
        instrs = eng.instructions
        dev = eng.device
    return _bench_line(args, config, instrs, dt, resumed_instrs,
                       device=dev.type)


def _bench_sharded(args, config) -> int:
    """``bench --backend jax`` over a ``(data, node)`` mesh (JAX
    ``cli.py:448-470``): ``GridEngine`` for ``--batch > 1``, else
    ``NodeShardedEngine``.  The ranks run a warm-up, then the timed
    run; the seconds are the slowest rank's timed loop (starting the
    ranks is not timed)."""
    from hpa2_tpu_torch.parallel import (
        GridEngine, NodeShardedEngine, make_mesh,
    )

    if args.checkpoint_every:
        raise SystemExit(
            "--checkpoint-every chunks the single-device batch loop; it "
            "does not compose with --node-shards/--data-shards")
    mesh = make_mesh(node_shards=args.node_shards,
                     data_shards=args.data_shards, device=args.device)
    gen = _generator(args.workload)
    if args.batch > 1:
        eng = GridEngine(
            config, [gen(config, args.instrs, seed=args.seed + b)
                     for b in range(args.batch)],
            mesh=mesh, max_cycles=args.max_cycles)
    else:
        eng = NodeShardedEngine(
            config, gen(config, args.instrs, seed=args.seed), mesh=mesh,
            max_cycles=args.max_cycles)
    eng.run(warmup=True)
    dt = max(r["seconds"] for r in eng.rank_stats)
    return _bench_line(args, config, eng.instructions, dt,
                       device=mesh.device,
                       collectives_per_cycle=eng.step_collectives)


def _bench_chunked(args, config):
    """The batch loop in chunks of ``--checkpoint-every`` simulated
    cycles (``hpa2_tpu/cli.py:505-590``): resume from the newest
    checkpoint in ``--checkpoint-dir`` when its config and workload
    match (refuse one from another run), save a checkpoint after each
    chunk, keep the newest two, and clear the directory at the end so
    a rerun starts fresh.  -> (device, final state, seconds, the
    instructions the resumed checkpoint had already retired)."""
    from hpa2_tpu_torch.models.spec_engine import StallError
    from hpa2_tpu_torch.ops.cuda_engine import resolve_device
    from hpa2_tpu_torch.ops.state import init_state_batched
    from hpa2_tpu_torch.ops.step import build_batched_run_chunk, quiescent
    from hpa2_tpu_torch.utils.checkpoint import (
        latest_checkpoint, load_state, save_state,
    )

    dev = resolve_device(args.device)
    state = init_state_batched(config, *_workload_arrays(args, config),
                               device=dev)
    ckdir = args.checkpoint_dir
    os.makedirs(ckdir, exist_ok=True)
    workload_meta = {"batch": args.batch, "instrs": args.instrs,
                     "workload": args.workload, "seed": args.seed}
    resume = latest_checkpoint(ckdir)
    if resume is not None:
        state, ck_config, ck_meta = load_state(resume, with_meta=True,
                                               device=dev)
        # the recovery counters are history, not workload identity
        ck_workload = {k: v for k, v in ck_meta.items() if k != "recovery"}
        if ck_config != config or ck_workload != workload_meta:
            raise SystemExit(
                f"checkpoint {resume} was written for a different "
                "config/workload; use a fresh --checkpoint-dir")
        print(f"resumed from {resume}", file=sys.stderr)
    run_chunk = build_batched_run_chunk(config, args.checkpoint_every)
    run_chunk(state)  # warm-up (captures the chunk's graph on the card)
    out = state
    # work already in the checkpoint does not count toward this
    # process's rate (read before the clock starts)
    resumed_instrs = int(out.n_instr.sum())
    t0 = time.perf_counter()
    k = int(out.cycle.max()) // args.checkpoint_every

    def seq(name):
        try:
            return int(name[5:-4])
        except ValueError:
            return None

    while not bool(quiescent(out).all()):
        if bool(out.overflow.any()):
            raise StallError(
                "internal invariant violated: mailbox overflow despite "
                "backpressure")
        if int(out.cycle.max()) >= args.max_cycles:
            raise StallError("batch did not reach quiescence")
        out = run_chunk(out)
        k += 1
        save_state(os.path.join(ckdir, f"ckpt_{k}.npz"), out, config,
                   extra_meta=workload_meta)
        # keep the newest two (the older guards against a crash while
        # the newest is written); other ckpt_*.npz names are left alone
        stale = sorted(
            (nm for nm in os.listdir(ckdir)
             if nm.startswith("ckpt_") and nm.endswith(".npz")
             and seq(nm) is not None),
            key=seq)[:-2]
        for old in stale:
            os.remove(os.path.join(ckdir, old))
    dt = time.perf_counter() - t0
    # finished: clear the checkpoints so a rerun starts fresh instead of
    # resuming the quiescent final state
    for name in os.listdir(ckdir):
        if name.startswith("ckpt_") and name.endswith(".npz"):
            os.remove(os.path.join(ckdir, name))
    if bool(out.overflow.any()) or not bool(quiescent(out).all()):
        raise StallError("batch did not reach quiescence")
    return dev, out, dt, resumed_instrs


def cmd_bench(args) -> int:
    """``bench``: one JSON line of a timed run with the JAX CLI's keys
    (``hpa2_tpu/cli.py:350-630``) for every backend: ``spec`` and
    ``omp`` on the host, ``jax`` (the general engine) and ``pallas``
    (the fast path, ``snapshots=False`` as ``bench.py``; the port's
    scheduler and trace-length flags are its own) on ``--device``."""
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
    from hpa2_tpu_torch.ops.schedule import Schedule
    from hpa2_tpu_torch.utils.trace import gen_heterogeneous_random_arrays

    config = _build_config(args)
    _check_shard_args(args)
    if args.data_shards > 1 and args.batch <= 1:
        raise SystemExit(
            "--data-shards > 1 needs --batch > 1 (an ensemble to "
            "shard); a single system would only be replicated"
        )
    if args.backend in ("spec", "omp"):
        return _bench_host(args, config)
    if args.backend == "jax":
        return _bench_jax(args, config)
    if args.trace_len_dist:
        if args.workload != "uniform":
            raise SystemExit(
                "--trace-len-dist draws heterogeneous lengths of the "
                "uniform workload; it does not apply to --workload "
                f"{args.workload}")
        arrays = gen_heterogeneous_random_arrays(
            config, args.batch, args.instrs, dist=args.trace_len_dist,
            spread=max(1.0, args.trace_len_spread), seed=args.seed)
    else:
        arrays = _workload_arrays(args, config)
    schedule = None
    if args.schedule_resident:
        schedule = Schedule(resident=min(args.schedule_resident, args.batch),
                            fused=not args.host_barriers)

    def build():
        kw = dict(block=args.block, cycles_per_call=args.cycles_per_call,
                  snapshots=False, trace_window=args.trace_window,
                  schedule=schedule, device=args.device)
        if args.node_shards > 1:
            from hpa2_tpu_torch.parallel import NodeShardedCudaEngine

            return NodeShardedCudaEngine(
                config, *arrays, node_shards=args.node_shards,
                data_shards=args.data_shards, **kw)
        if args.data_shards > 1:
            from hpa2_tpu_torch.parallel import DataShardedCudaEngine

            return DataShardedCudaEngine(config, *arrays,
                                         data_shards=args.data_shards, **kw)
        return CudaEngine(config, *arrays, **kw)

    build().run(args.max_cycles)  # warm-up (builds the kernel)
    eng = build()
    t0 = time.perf_counter()
    eng.run(args.max_cycles)  # ends in the status readback
    dt = time.perf_counter() - t0
    if args.node_shards > 1 and eng.cycle:
        print(f"[pallas] cross-shard msgs: {eng.cross_shard_msgs} "
              f"({eng.cross_shard_msgs / eng.cycle:.2f}/cycle)",
              file=sys.stderr)
    extra = {"device": eng.device.type}
    if args.trace_len_dist:  # the workload is named by its lengths
        extra["workload"] = args.trace_len_dist
    if schedule is not None:
        extra["occupancy"] = eng.occupancy.as_dict()
    return _bench_line(args, config, eng.instructions, dt, **extra)


def _migration_targets(spec: str) -> List[dict]:
    """``--migrate-to``'s ``backend[:data_shards[:node_shards]]``
    entries (``hpa2_tpu/cli.py:688-708``); a target with node shards
    above 1 serves on ``pallas-node-sharded``, a pallas target with data
    shards only on ``pallas-sharded``."""
    targets = []
    for part in spec.split(","):
        fields = part.strip().split(":")
        if not fields[0] or fields[0] not in ("jax", "pallas"):
            raise SystemExit(
                "--migrate-to takes backend[:data_shards[:node_shards]] "
                "entries (backend jax|pallas)")
        t = {"backend": fields[0]}
        try:
            if len(fields) > 1:
                t["data_shards"] = int(fields[1])
            if len(fields) > 2:
                t["node_shards"] = int(fields[2])
        except ValueError:
            raise SystemExit(f"--migrate-to: bad shard count in {part!r}")
        if t.get("node_shards", 1) > 1:
            t["backend"] = "pallas-node-sharded"
        elif t["backend"] == "pallas" and t.get("data_shards", 1) > 1:
            t["backend"] = "pallas-sharded"
        targets.append(t)
    return targets


def cmd_serve(args) -> int:
    config = _build_config(args)
    backend = args.backend
    if args.node_shards > 1:
        if backend != "pallas":
            raise SystemExit(
                "--node-shards serving runs on the pallas backend "
                "(the resident NodeShardedLaneSession; the jax rows "
                "are single-shard)")
        if args.nodes % args.node_shards != 0:
            raise SystemExit(
                f"--node-shards {args.node_shards} must divide "
                f"--nodes {args.nodes} (shards own contiguous equal "
                "node blocks)")
        backend = "pallas-node-sharded"
    elif backend == "pallas" and args.data_shards > 1:
        backend = "pallas-sharded"
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

    plan = None
    if args.failure_plan:
        import dataclasses

        from hpa2_tpu_torch.config import FailurePlan

        try:
            plan = FailurePlan.parse(args.failure_plan,
                                     seed=args.failure_seed)
        except ValueError as e:
            raise SystemExit(f"--failure-plan: {e}")
        # the plan is config data: record it where checkpoints (and
        # anything else hashing the run) can see it
        config = dataclasses.replace(config, failures=plan)
    targets = _migration_targets(args.migrate_to) if args.migrate_to \
        else None

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
                failures=plan,
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

    serve_fn = serve
    serve_kw = {}
    if (plan is not None and plan.enabled) or args.checkpoint_dir:
        from hpa2_tpu_torch.serving import supervised_serve

        serve_fn = supervised_serve
        if args.checkpoint_dir:
            os.makedirs(args.checkpoint_dir, exist_ok=True)
        serve_kw = dict(plan=plan, targets=targets,
                        checkpoint_dir=args.checkpoint_dir,
                        checkpoint_every=args.checkpoint_every)
    try:
        _, stats = serve_fn(
            config, source,
            backend=backend,
            data_shards=args.data_shards,
            node_shards=args.node_shards,
            resident=args.resident,
            window=args.window,
            block=args.block,
            policy=args.policy,
            overlap=not args.no_overlap,
            interval=args.interval,
            max_trace_len=args.max_instr,
            max_cycles=args.max_cycles,
            decode_dumps=bool(out),
            emit=emit,
            tenant_weights=tenants.weights or None,
            device=args.device,
            **serve_kw,
        )
    finally:
        source.close()
        if results_fh:
            results_fh.close()
    print(json.dumps(stats.as_dict()))
    return 0


def _add_shards(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data-shards", type=int, default=1,
                   help="split the ensemble over this many cards "
                   "(bench --batch > 1, serve)")
    p.add_argument("--node-shards", type=int, default=1,
                   help="split a system's nodes over this many ranks, "
                   "one card each (--backend jax or pallas)")
    p.add_argument("--exchange-mode", default="a2a",
                   choices=("pairwise", "a2a", "butterfly", "hier"),
                   help="cross-shard exchange schedule under "
                   "--node-shards (ops/exchange.py)")
    p.add_argument("--exchange-inner", type=int, default=0,
                   help="hier exchange: inner-tier size (0 = auto)")


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
        "--messages-per-cycle", type=int, default=1,
        help="lockstep schedule: messages drained per node per cycle "
        "(spec backend; >1 shortens latency chains on queue-bound "
        "workloads)",
    )
    p.add_argument(
        "--robust", action="store_true",
        help="NACK/retry on stale interventions (sound at scale)",
    )
    p.add_argument(
        "--head-quirks", action="store_true",
        help="emulate all of the reference HEAD's divergences from its "
        "own fixtures; spec and omp backends",
    )
    p.add_argument(
        "--quirks", default="", metavar="LIST",
        help="comma-separated HEAD quirks to enable individually: "
        "eager-write, flush-old-fill (all backends), "
        "overloaded-notify (spec/omp only)",
    )
    p.add_argument(
        "--free-running", action="store_true",
        help="omp backend: thread-per-node free-running mode like the "
        "reference (nondeterministic interleavings)",
    )
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="jax and pallas backends: cuda runs on the GPU (the fast "
        "path launches its kernel); cpu runs the same path on the CPU "
        "(the kernel's plain PyTorch version).  The spec and omp "
        "backends run on the host",
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
        "--backend", choices=("spec", "jax", "omp", "pallas"),
        default="jax",
        help="jax = the general engine (every protocol, directory "
        "format, topology and fault); pallas = the fast path; spec = "
        "the executable spec; omp = the C++/OpenMP engine of native/",
    )
    rp.add_argument("--out", help="output directory (default: CWD)")
    rp.add_argument(
        "--replay", default=None,
        help="instruction_order.txt to replay (spec, jax, omp)",
    )
    rp.add_argument(
        "--trace-msgs", metavar="PATH", default=None,
        help="write a per-message send/receive log in the reference's "
        "DEBUG_MSG format; spec and omp backends",
    )
    rp.add_argument(
        "--record-order", default=None, metavar="PATH",
        help="write the executed issue interleaving in DEBUG_INSTR "
        "format (replayable via --replay); spec and omp backends",
    )
    rp.add_argument(
        "--final-dump", action="store_true",
        help="dump final quiescent state instead of at local completion",
    )
    rp.add_argument(
        "--crash-at", type=int, default=0, metavar="CYCLE",
        help="spec backend: simulate a crash: advance to CYCLE, write "
        "--crash-checkpoint, exit (no dumps)",
    )
    rp.add_argument(
        "--crash-checkpoint", default="hpa2_spec_ckpt.json",
        metavar="PATH",
        help="where --crash-at persists the engine state (JSON)",
    )
    rp.add_argument(
        "--resume", default=None, metavar="PATH",
        help="spec backend: resume from a --crash-at checkpoint (of "
        "either package) and finish the run, byte-identical to an "
        "uninterrupted one; trace_dir is ignored",
    )
    _add_shards(rp)
    _add_common(rp)
    rp.set_defaults(fn=cmd_run)

    bp = sub.add_parser("bench", help="synthetic benchmark, JSON result")
    bp.add_argument(
        "--backend", choices=("jax", "pallas", "omp", "spec"),
        default="jax",
        help="jax = the general engine; pallas = the fast path (the "
        "--block, --trace-window, --cycles-per-call, --trace-len-* and "
        "--schedule-* flags are its own); spec = the executable spec "
        "(batch 1); omp = the C++/OpenMP engine (uniform, batch 1)",
    )
    bp.add_argument(
        "--workload",
        choices=("uniform", "producer-consumer", "local"),
        default="uniform",
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
        help="jax backend with --batch > 1: advance in chunks of CYCLES "
        "simulated cycles, checkpoint after each into --checkpoint-dir "
        "and resume from the newest there (0: off)",
    )
    bp.add_argument("--checkpoint-dir", default="hpa2_ckpt")
    _add_shards(bp)
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
        help="pallas = the resident-lane fast path; jax = rows of the "
        "general engine (the backend with fault injection, the protocol "
        "variants and the topologies)",
    )
    _add_shards(sp)
    sp.add_argument(
        "--resident", type=int, default=16,
        help="device-resident lanes (the fixed serving shape)",
    )
    sp.add_argument("--window", type=int, default=16,
                    help="pallas backend: trace-window segment length")
    sp.add_argument("--block", type=int, default=1024,
                    help="pallas backend: lane block width (clamped to "
                    "resident)")
    sp.add_argument("--interval", type=int, default=256,
                    help="jax backend: cycles per chunk between "
                    "completion checks")
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
    fp = sp.add_argument_group("fault tolerance")
    fp.add_argument(
        "--failure-plan", default=None, metavar="SPEC",
        help="seeded failure injection: 'kind@interval[:target]' events "
        "joined by ';' (kill, hang, poison, sever); arms the recovery "
        "supervisor")
    fp.add_argument("--failure-seed", type=int, default=0,
                    help="seed folded into the failure plan")
    fp.add_argument(
        "--migrate-to", default=None, metavar="B[:D[:N]],...",
        help="migration target rotation: backend[:data_shards"
        "[:node_shards]] entries tried in order on each kill/hang "
        "(default: cross the pallas<->jax divide; shards above 1 are "
        "refused)")
    fp.add_argument(
        "--checkpoint-dir", default=None, metavar="DIR",
        help="supervisor checkpoints (schema-v2 npz of the rows on the "
        "jax backend, JSON manifests on pallas) land here every "
        "--checkpoint-every interval barriers; arms the supervisor")
    fp.add_argument("--checkpoint-every", type=int, default=1,
                    metavar="K")
    _add_common(sp)
    sp.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
