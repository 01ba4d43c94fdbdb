"""Command line of the port: ``run`` and ``bench`` on the streamed fast
path, with the flag names of ``python -m hpa2_tpu.cli``.

    python -m hpa2_tpu_torch run TRACE_DIR [--out DIR] [--final-dump]
    python -m hpa2_tpu_torch bench --batch 4096 --instrs 128 --seed 0
    python -m hpa2_tpu_torch bench --batch 32768 --instrs 128 --nodes 8 \
        --msg-buffer-size 16 --robust --block 512 --trace-window 32 \
        --trace-len-dist zipf --schedule-resident 8192 [--host-barriers]

``run`` simulates one system from ``core_<n>.txt`` traces and writes
``core_<n>_output.txt`` dumps (at local completion, or of the final
state with ``--final-dump``), byte-identical to
``python -m hpa2_tpu.cli run --backend pallas``.  ``bench`` times an
ensemble of random workloads (``snapshots=False``, as ``bench.py``),
uniform or with heterogeneous per-system trace lengths, optionally
under the occupancy scheduler, and prints one JSON line.  Both run on
the GPU unless ``--device cpu`` is given.
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

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
