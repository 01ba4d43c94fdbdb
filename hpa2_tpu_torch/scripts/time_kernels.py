"""Time the fast path's kernels on one NVIDIA GPU at the repo's two
full-width configurations, or the node axis's wide kernels.

    python hpa2_tpu_torch/scripts/time_kernels.py [--tree DIR] [--reps N]
    python hpa2_tpu_torch/scripts/time_kernels.py --wide [--tree DIR] [--reps N]

Times K2 (``kernels.stream_run``, the whole streamed run) and K3
(``kernels.call_run`` under its host loop ``run_windows``, each launch
timed) at the 8-node headline (32,768 systems x 8 nodes x 128
instructions, block 512, window 32, k 128) and at 64 nodes (1,024 x 64
x 64, block 512, window 16, k 64; K2 also with packed planes), each
launch on fresh planes made from seed 0, timed by CUDA events around
the launch alone.

``--tree DIR`` times the ``hpa2_tpu_torch`` package of another checkout
(its kernels are built from its own sources), so that two versions can
be timed in turns (A, B, B, A) in one session on one card; the script
uses only what both versions have.  Prints one JSON line: the card,
the tree, and per path the ms of each repetition, the RD/WR
instructions retired, the system-cycles (the sum of the cycle counter
over systems), the longest system's cycles, and a digest of the final
planes (equal digests, equal planes).

``--wide`` times the node kernels' wide family instead (``node_*_wide``,
``ops/node_cycle.py``) over 4 logical ranks on the card, a2a, at the
node axis's geometry (4,096 nodes x 8 systems x 2 instructions a core)
and at 256 nodes x 256 x 4 (:data:`WIDE_PATHS`): one 4-cycle call whose
cycle 2 keeps each stage's inputs, then each wide entry launched alone
on them (``NodeCycle.time_kept``: the median of ``--reps`` launches, CUDA
events around the launch, the plain version and the whole wrapper
beside it), with the bytes bound, the main launch's grid and a digest
of the kept planes (equal digests, equal inputs across trees); and each
CUDA kernel of those entries by name (an entry may launch several), its
launches and median device us, from ``torch.profiler`` over ``--reps``
launches of each kept stage's kernels alone.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

#: the paths: (name, kernel, num_procs, batch, instrs, block, window, k,
#: packed); headline: bench.py:50-51, 74-82; 64 nodes:
#: scripts/scale_runs.py:265-276
PATHS = (
    ("K2 headline", "stream", 8, 32768, 128, 512, 32, 128, False),
    ("K3 headline", "call", 8, 32768, 128, 512, 32, 128, False),
    ("K2 64 nodes", "stream", 64, 1024, 64, 512, 16, 64, False),
    ("K3 64 nodes", "call", 64, 1024, 64, 512, 16, 64, False),
    ("K2 64 nodes packed", "stream", 64, 1024, 64, 512, 16, 64, True),
)
#: ``--wide``'s paths, 4 logical ranks, a2a: (name, nodes, systems,
#: instructions a core); chip_smoke.py's NODEKERN_WIDE_RUNS
WIDE_PATHS = (
    ("wide 4096 nodes", 4096, 8, 2),
    ("wide 256 nodes", 256, 256, 4),
)
#: the cycles of ``--wide``'s call, and the cycle whose inputs it keeps
WIDE_CALL, WIDE_KEEP_AT = 4, 2
#: HBM bytes a second of an H100 SXM (the bound's rate)
HBM_BYTES_PER_S = 3.35e12


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                   help="checkout whose hpa2_tpu_torch is timed")
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--wide", action="store_true",
                   help="time the node kernels' wide family")
    args = p.parse_args(argv)
    if args.reps < 1:
        p.error("--reps must be at least 1")
    if not (Path(args.tree) / "hpa2_tpu_torch").is_dir():
        p.error(f"--tree {args.tree}: no hpa2_tpu_torch package there")
    args.tree = str(Path(args.tree).resolve())
    return args


def _wide_rank(job):
    """One ``WIDE_CALL``-cycle call on this logical rank, cycle
    ``WIDE_KEEP_AT``'s stage inputs kept; rank 0 then times each wide
    entry on them while the others wait."""
    import hashlib
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from hpa2_tpu_torch.ops.cycle import TRANSIENTS
    from hpa2_tpu_torch.ops.layout import _init_state
    from hpa2_tpu_torch.parallel.comm import world_comm
    from hpa2_tpu_torch.parallel.sharding import (
        NodeInterval, _node_local, _rank_device,
    )

    eng = job["engine"]
    cfg = eng.config
    comm, _ = world_comm(job["mesh"].node)
    dev = _rank_device(job["mesh"])
    nl = cfg.num_procs // comm.size
    node = slice(comm.rank * nl, (comm.rank + 1) * nl)
    tr = eng._tr_full[node][:, :eng._window].contiguous().to(dev)
    tl = eng._tr_len_full[node].clamp(max=eng._window).contiguous().to(dev)
    st = _node_local(_init_state(cfg, tr.shape[-1], False, False),
                     comm.rank, nl, slice(None), dev)
    trans = {f: torch.zeros((1, tr.shape[-1]), dtype=torch.int32,
                            device=dev) for f in TRANSIENTS}
    prog = NodeInterval(cfg, comm, False, eng._window, WIDE_CALL, 1)
    prog.cycle.keep_at = WIDE_KEEP_AT
    prog(st, trans, tr, tl)
    comm.barrier()
    out = None
    if comm.rank == 0:
        kept = prog.cycle.kept[prog.cycle.AB.name][0]
        digest = hashlib.sha256()
        for f in sorted(kept):
            digest.update(f.encode())
            digest.update(kept[f].cpu().numpy().tobytes())
        times = prog.cycle.time_kept(reps=job["reps"])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(job["reps"]):
                _launch_kept(prog.cycle)
            torch.cuda.synchronize(dev)
        us = {}
        for e in prof.events():
            m = re.search(r"node_[a-z_]+_wide[a-z_]*_kernel", e.name)
            if m and e.device_type == torch.autograd.DeviceType.CUDA:
                us.setdefault(m.group(0), []).append(
                    e.time_range.elapsed_us())
        kern = {k: dict(launches=len(v), median_us=sorted(v)[len(v) // 2])
                for k, v in sorted(us.items())}
        out = dict(times=times, kernels=kern, digest=digest.hexdigest()[:16])
    comm.barrier()
    return dict(planes={}, status=0, times=out)


def _launch_kept(nc) -> None:
    """Each kept stage's kernel launches once, on copies of its kept
    inputs (as ``NodeCycle.time_kept`` launches them)."""
    from hpa2_tpu_torch.ops import exchange
    from hpa2_tpu_torch.ops.node_cycle import _copies

    for name, kept in nc.kept.items():
        if name == nc.AB.name:
            s0, seg, w = kept
            nc.node_ab(_copies(s0), seg, w)
        elif name == nc.BUCKET.name:
            fsbuf, _, blocks, dests, k, src, combine = kept
            nc.bucketer.fsbuf = fsbuf.clone()
            fs = dict(zip(exchange.FSTATS, nc.bucketer.fsbuf.unbind(0)))
            nc.bucketer(fs, blocks, dests, k, src, combine)
        elif name == nc.DELIVER.name:
            s0, blocks, origins = kept
            nc.node_deliver(_copies(s0), blocks, origins)
        else:
            s0, acc, cnt, fs, seg, w = kept
            nc.node_settle(_copies(s0), acc, cnt, fs, seg, w)


class _WideJob:
    """``_wide_rank`` on every rank of an engine's mesh, for
    ``run_node_sharded``; ``rows`` the ranks' answers."""

    def __init__(self, engine, reps):
        self.engine, self.mesh, self.reps = engine, engine.mesh, reps
        self.rows = []

    def _job(self):
        return dict(rank_fn=_wide_rank, engine=self.engine, mesh=self.mesh,
                    config=self.engine.config, reps=self.reps)

    def _gather(self, blocks):
        self.rows = blocks

    def _check(self):
        pass


def wide(reps: int) -> dict:
    """``--wide``: each path's wide entries timed on its kept cycle."""
    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.parallel import NodeShardedCudaEngine, make_mesh
    from hpa2_tpu_torch.parallel.sharding import run_node_sharded
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    out = {}
    for name, n, b, t in WIDE_PATHS:
        cfg = SystemConfig(num_procs=n, msg_buffer_size=16,
                           semantics=Semantics().robust(), max_instr_num=0)
        arrays = gen_uniform_random_arrays(cfg, b, t, seed=n)
        eng = NodeShardedCudaEngine(
            cfg, *arrays, mesh=make_mesh(node_shards=4, device="cuda",
                                         local=True),
            block=b, cycles_per_call=WIDE_CALL)
        job = _WideJob(eng, reps)
        run_node_sharded([job])
        got = next(r["times"] for r in job.rows if r["times"])
        out[name] = dict(digest=got["digest"], kernels=got["kernels"], entries={
            k: dict(ms=tm["ms"], wrapper_ms=tm["wrapper_ms"],
                    plain_ms=tm["plain_ms"], bytes=tm["bytes"],
                    bound_ms=tm["bytes"] / HBM_BYTES_PER_S * 1e3,
                    grid=tm["grid"], empty_ms=tm["empty_ms"])
            for k, tm in got["times"].items()})
        print(f"[time_kernels] {name}: " + ", ".join(
            f"{k} {v['ms']:.4f} ms" for k, v in out[name]["entries"].items()),
            file=sys.stderr)
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, args.tree)

    import numpy as np
    import torch

    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.convert import state_from_numpy
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.call_run import run_windows
    from hpa2_tpu_torch.ops.layout import _init_state, _pack_traces
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    if not torch.cuda.is_available():
        print("time_kernels: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    if args.wide:
        kernels.NODE_CYCLE.build()
        print(json.dumps({"card": card, "tree": args.tree,
                          "paths": wide(args.reps)}))
        return 0
    kernels.build_all()

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        return start, end

    out = {}
    for name, kern, n, b, t, block, window, k, packed in PATHS:
        cfg = SystemConfig(num_procs=n, msg_buffer_size=16,
                           semantics=Semantics().robust())
        op, addr, val, length = gen_uniform_random_arrays(cfg, b, t, seed=0)
        n_seg = -(-t // window)
        tr = np.pad(_pack_traces(cfg, op, addr, val, length),
                    ((0, 0), (0, n_seg * window - t), (0, 0)))
        tr = torch.from_numpy(tr).cuda()
        tr_len = torch.from_numpy(np.ascontiguousarray(length.T)).cuda()
        state = state_from_numpy(_init_state(cfg, b, False, packed), "cuda")
        kw = dict(block=block, k=k, window=window, n_seg=n_seg,
                  max_calls=10_000, gate=True, snapshots=False,
                  packed=packed)
        times = []
        for rep in range(args.reps + 1):  # the first is a warm-up
            got = {f: v.clone() for f, v in state.items()}
            torch.cuda.synchronize()
            events = []
            if kern == "stream":
                events.append(timed(
                    lambda: kernels.stream_run(cfg, got, tr, tr_len, **kw)))
            else:
                def call(*a, **kk):
                    events.append(timed(lambda: kernels.call_run(*a, **kk)))
                run_windows(cfg, got, tr, tr_len, call=call, **kw)
            torch.cuda.synchronize()
            if rep:
                times.append(sum(s.elapsed_time(e) for s, e in events))
        digest = hashlib.sha256()
        for f in sorted(got):
            digest.update(f.encode())
            digest.update(got[f].cpu().numpy().tobytes())
        cyc = got["scalars"][0].long()
        out[name] = dict(ms=times, launches=len(events),
                         instructions=int(got["scalars"][1].long().sum()),
                         system_cycles=int(cyc.sum()),
                         max_cycle=int(cyc.max()),
                         digest=digest.hexdigest()[:16])
        print(f"[time_kernels] {name}: {times} ms", file=sys.stderr)
    print(json.dumps({"card": card, "tree": args.tree, "paths": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
