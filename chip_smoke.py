#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only compare,serve,general-scheduled,serve-jax,recovery,entry,analysis,ablate,scale,shard,nodeshard,nodekern

(the second form, a debugging aid, runs the build and the named phases
alone and prints no kernels line).  Builds the six CUDA libraries from
``hpa2_tpu_torch/csrc`` with nvcc,
the compilers at once (the streamed run ``stream_run.cu`` and the
per-call kernel ``call_run.cu``, each for node bounds 8, 21 and 64,
each again with ``-DHPA2_ABLATE`` as K1's ablation variant, the
op-pattern micro-kernels ``micro_kernels.cu``, and K1's node-sharded
cycle ``node_cycle.cu``: N1-N4), runs the
micro-kernels' runner (``hpa2_tpu_torch.scripts.micro_kernels``: its
``main()`` at 8,192 lanes and its ``bench`` at 32,768) and holds each
pattern's kernel bit for bit against its plain version at both sizes,
holds the fast path's kernels bit for bit against their plain PyTorch
versions (streamed run: cases a-e at up to 8 nodes, f:
split sharer planes at 22, 33 and 64 nodes, g: packed planes; per-call
kernel under its host loop: case h at 4, 8, 22 and 33 nodes, ragged
windows, gate on and off, packed, and a stall; both kernels: case i, a
lane block over several CTAs with one CTA idle from the start and
snapshots on, and case j, a stalled block over two CTAs; case k, lane
blocks above 1,024 lanes, up to the card's largest at the 8-node
bound; every case's plain version but the largest lane block's runs in
a pool of host worker processes, one core each, while the card works
through the micro-kernels, the ablation and the scaled configurations,
as do those of the checked launches of at most 2,048 lanes in later
phases), and drives through ``CudaEngine``:

* the streamed fast path at the repo's headline width (32,768 systems
  x 8 nodes x 128 instructions per core) and at its 64-node
  single-chip width (1,024 systems x 64 nodes, unpacked and packed;
  ``scripts/scale_runs.py``'s single-device rung, cut from 64
  instructions a core to 32); the packed run is held against the unpacked kernel's planes,
  which are held against the plain version, so it runs no plain
  version of its own;
* the per-call path (``stream=False``) at the same two widths, held
  against the streamed run's planes (at 64 nodes against those alone,
  for the same reason);
* the occupancy scheduler on ``bench.py --trace-len-dist zipf``'s
  workload at the headline shape (up to 64 instructions a core where
  bench.py has 128): unscheduled, fused, fused with 8,192
  resident lanes, the same with host barriers, and with the per-call
  kernel inside; the unscheduled and resident fused runs first in a
  run whose every launch is held against the plain version on its own
  planes and windows, the others held plane for plane against those;
* a resident-lane session (``CudaLaneSession``), its launches held
  against the plain version, and its results against the one-shot
  run;
* always-on serving (``hpa2_tpu_torch.serving.serve``) at
  ``bench.py``'s accelerator geometry (4,096 resident lanes, window 32,
  block 512; 8,192 zipf jobs of up to 64 instructions a core where
  bench.py's feed has 16,384 of up to 128): a
  checked pass whose every launch is held against the plain version,
  then the
  pipelined run, the serial run, a Poisson-arrival run, a framed-wire
  run with two clients and the ``serve`` command, every served job's
  dumps equal to the one-shot scheduled run's;
* the general engine (``hpa2_tpu_torch.ops.engine``, ``[general]``), at
  ``bench.py``'s headline configuration at 64 instructions a core (where
  it has 128): 4,096 systems x 8 nodes, elision on and off, held against K2 on the same arrays
  (dumps, snapshots, counters, cycle) and against the CPU on 64
  systems; MOESI, MESIF, ``limited:2``, ``coarse:4``, ``mesh2d`` with
  multicast, ``torus2d`` with combining, ``hierarchical`` and
  ``bench.py``'s fault mix at 1,024 systems each, held against the CPU
  on 32 systems in every state field; the 64-node configuration at 256
  systems against K2; a severed edge whose ``StallDiagnostic`` must
  equal the CPU's; and ``run``/``bench --backend jax`` (the CPU
  references run in four spawned worker processes meanwhile);
* the general engine's scheduled runs (``[general scheduled]``): 4,096
  zipf-length headline systems unscheduled, fused and by the host chunk
  loop through 1,024 rows (each scheduled run's dumps, snapshots,
  counters and ``stats()`` equal to the unscheduled run's), and 32 of
  them through 8 rows against the CPU in every field;
* serving on the general engine (``[serve jax]``): 2,048 zipf jobs
  through 1,024 rows at interval 256, pipelined and serial, against
  the one-shot host-loop run, then ``jax_window=32`` against the fast
  path's serving with every K2 launch held against the plain version;
* the recovery supervisor (``[recovery]``): the fast path primary at
  1,024 lanes on 2,048 of those jobs under kill, hang and poison (and
  kill again with the primary's K2 launches checked), each
  byte-identical to the unfailed run; a jax -> jax kill that resumes
  rows from a schema-v2 checkpoint; a checkpoint of rows on the card
  loaded back; ``bench --backend jax --checkpoint-every`` straight and
  resumed; and the ``serve --backend jax`` and ``serve --failure-plan``
  commands;
* the ``run`` command on a small trace directory and the ``bench``
  command on the fast path (``--backend pallas``), unscheduled and
  scheduled;
* the entry points (``[entry]``, :func:`phase_entry`): the bench
  harness ``hpa2_tpu_torch.bench`` (the headline with the OpenMP
  baseline, ``--topology``, ``--protocol``, ``--serve``,
  ``--failover``), ``bench --workload producer-consumer|local`` against
  the spec engine, K2 under the HEAD value quirks, and ``run`` with
  ``--backend spec|omp``, ``--quirks`` and ``--crash-at``/``--resume``,
  every K2 launch held against the plain version,
* the analysis suite (``[analysis]``, :func:`phase_analysis`): ``equiv``
  with K3 as the ``pallas`` table prober (every probeable MESI row a
  lane of one launch, each launch held against the plain version),
  ``spec``, ``jax`` and ``native`` at MESI and ``jax`` at MOESI and
  MESIF; ``contracts`` on the card; the elision model's verify against
  ``TorchEngine`` on the card; ``lint``; ``mutation-test``,
* K1's ablation variant (``[ablate]``, :func:`phase_ablate`): an
  ablated ``CudaEngine`` run (a deliberately wrong cycle, stalled at its
  budget) on every ablation instantiation, K2 and K3 at node bounds 8,
  21 and 64, int32 and packed planes, every stage alone and all three,
  in lane blocks of one CTA and in the clusters of ``perf_sweep``'s
  attribution (block 512), each launch held against the plain ablated
  version,
* several GPUs (``[shard]``, :func:`phase_shard`,
  ``hpa2_tpu_torch.parallel``): the headline ensemble through
  ``DataShardedCudaEngine`` over every card (two shards on one card)
  equal to the one-card run with one status read, a checked pass whose
  every K2 and K3 launch is held against the plain version, a fused
  scheduled zipf run equal to the unsharded one, and the general
  engine's node axis over NCCL (``NodeShardedEngine`` at 8 and 16 nodes,
  a2a and pairwise, equal to ``TorchEngine``, a cycle's collectives
  equal to the plan's plus one SUM and one MAX; one rank on one card),
* the fast path's node axis (``[nodeshard]``, :func:`phase_nodeshard`):
  on two cards or more, ``NodeShardedCudaEngine`` (its cycle the node
  kernels N1-N4) at 64 nodes x 1,024 systems x 8 instructions over 4
  NCCL ranks and a 2 x 2 grid (2 ranks on two or three cards),
  each equal to K2 on ``cuda:0``, the first run's first k-cycle call
  held launch by launch against the tensor cycle, the CUDA kernels a
  cycle by ``torch.profiler``, a fused packed zipf run and a served feed
  through ``NodeShardedLaneSession``; on one card one line saying it
  needs two,
* K1's node-sharded cycle as its kernels on ONE card (``[nodekern]``,
  :func:`phase_nodekern`): the node ranks logical (threads of this
  process meeting through ``parallel/comm.py:LocalComm``), 64 nodes x
  1,024 systems x 8 instructions over 2 and 4 ranks (a2a, pairwise,
  butterfly and hier at 4), 12 nodes packed and 22 split over 2, each
  equal to K2, every N1-N4 launch of each run's first k-cycle call held
  against its plain version (hier's combining count included); the CUDA
  kernels a cycle; each kernel's and plain version's time on a real
  cycle's inputs over 2 and over 4 ranks,
* BASELINE.json's scaled configurations (``[scale]``,
  :func:`phase_scale`, through ``hpa2_tpu_torch.scripts.scale_runs``):
  configuration 5 at full size (1,024 systems x 8 nodes x 10,000
  instructions on K2, trace windows of 32), 16 of its systems held
  against the spec engine on the same windows, and configuration 4 at
  full width (256 nodes, the general engine) and 128 instructions a core
  against ``TorchEngine`` on the CPU,

and prints:

* the card's name and power limit (``nvidia-smi``);
* per kernel instantiation, ptxas's registers, stack frame and spills,
  and the shared memory, CTAs an SM and clusters the card holds at
  once at lane blocks of 512 and 1,024, each held against the Hopper
  budget model (``analysis/vmem.py``; ``[build]``);
* the host syncs of each path (``[syncs]``);
* per general-engine run, its ms by CUDA events, cycles, device steps
  after elision, RD/WR ops/s, launches a chunk, chunks and host syncs,
  with the card's name and power limit (``[general]``);
* per serving run, its jobs, intervals, admissions and compactions,
  sustained RD/WR ops/s and wall time, the host staging, device wait
  and readback split, p50/p99 latency, launches, host syncs and compile
  counts, and the time the pipeline hid against the serial run
  (``[serve]``);
* one ``{"kernels": [...]}`` line: per kernel its launches on its main
  path (the 64-node streamed run; the headline per-call run; the
  micro-kernels' runner; the ablation libraries' ``[ablate]`` runs, whose
  bound is by bytes alone; N1-N4's ``[nodekern]`` runs, their checked
  launches, and their bound by the bytes each must move on a kept
  cycle's inputs: what its body reads for that cycle's data, the plane
  words it changes and its outputs; the pipelined serving run, K2's cross-checks
  beside the general engine and its served rows, the recovery
  supervisor's primary, K3 as the analysis suite's table prober, and
  K2's ``[scale]`` configuration 5, under ``by_path``; a path held
  against already-checked planes instead of a plain run names them under
  ``held_to``), its
  largest disagreement with the plain version, its time and the plain version's at that shape, and its
  bound: the larger of the bytes over 3.35 TB/s and the integer
  operations the run's own counters say it needed (``cycle_ops``) over
  ``SCALAR_OPS_PER_S`` (``by_path`` holds the same for every path driven,
  ``patterns`` the micro-kernels' per pattern and size);
* last, ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero and prints no
result; so does a machine without CUDA or a directory without the
package.  Imports only ``hpa2_tpu_torch``, torch, numpy and the
standard library.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
#: H100 SXM device memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores, ops/s; the scalar
#: 32-bit integer work of the kernels is held to it (one warp
#: instruction a clock in each quarter of an SM, a fused IMAD, IADD3 or
#: LOP3 counted as two ops; the INT32 pipe's 64 lanes an SM alone give a
#: quarter of it, which IMAD on the FMA pipe can beat)
SCALAR_OPS_PER_S = 67e12
#: Integer operations a run of the cycle needs, counted from
#: csrc/cycle.cuh for what any implementation must compute (loads,
#: stores and this design's exchange not counted; a division counts as
#: one op).  Per node and system-cycle with work, its checks: decode the
#: four nsw fields (7), the window's length (5), the five outbox slots'
#: validity (15), the blocked, activity and issue tests (16) and the nsw
#: repack (7).
OPS_NODE_CYCLE = 50
#: per message, handled (decode five fields and split the address: 19;
#: decode the cache and directory words and the sharer set: 15; the
#: protocol's tests and updates: 18; pack one reply: 8; encode the cache
#: and directory words written back: 10) and delivered (the candidate
#: and room tests, the queue count, the type count: 10)
OPS_MESSAGE = 80
#: per retired RD/WR: decode the trace word and split its address (7),
#: decode the cache word and test the hit (10), the read/write and
#: upgrade tests (12), pack the request (8), encode the line (6), the
#: counters (7)
OPS_ISSUE = 50
#: the micro-kernels' sizes: the script's own grid of 256-lane blocks,
#: and the headline's 32,768 lanes
MICRO_GRIDS = (32, 128)

HEADLINE = dict(num_procs=8, msg_buffer_size=16)   # bench.py:50-51, 74-82
HEADLINE_RUN = dict(block=512, k=128, window=32, gate=True)
# scripts/scale_runs.py:265-276, the single-device rung of `nodeshard`
# (its depth cut from 64 instructions a core to 32 for the time limit)
WIDE = dict(num_procs=64, msg_buffer_size=16, max_instr_num=0)
WIDE_RUN = dict(block=512, k=64, window=16, gate=True)
WIDE_INSTRS = 32
#: worker processes (one thread each) that run plain versions on the
#: host while the card works (:func:`host_pool`): the compare cases',
#: and those of checked and kept launches on at most HOST_CHECK_LANES
#: lanes; a bigger launch runs its plain version on the card, where it
#: is faster than on one host core
HOST_WORKERS = 5
HOST_CHECK_LANES = 2048
#: the pool, once started; the compare cases whose plain versions are
#: still running there (:func:`settle_compare`)
HOST_POOL, PENDING = [], []


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def planes_for(cfg, b, t, seed, snapshots, window, packed=False, idle=0,
               block=1, device="cuda"):
    """Initial planes and packed traces on ``device``, from a seed; the
    first ``idle`` lanes of each ``block`` get empty traces."""
    from hpa2_tpu_torch.convert import state_from_numpy
    from hpa2_tpu_torch.ops.layout import _init_state, _pack_traces
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    op, addr, val, length = gen_uniform_random_arrays(cfg, b, t, seed=seed)
    length.reshape(b // block, block, -1)[:, :idle] = 0
    n_seg = -(-t // window)
    tr = _pack_traces(cfg, op, addr, val, length)
    tr = np.pad(tr, ((0, 0), (0, n_seg * window - t), (0, 0)))
    state = state_from_numpy(_init_state(cfg, b, snapshots, packed), device)
    return (state, torch.from_numpy(tr).to(device),
            torch.from_numpy(np.ascontiguousarray(length.T)).to(device), n_seg)


def host_pool():
    """The script's host workers (spawned at first use; :func:`main`
    shuts them down)."""
    if not HOST_POOL:
        import concurrent.futures
        import multiprocessing

        HOST_POOL.append(concurrent.futures.ProcessPoolExecutor(
            max_workers=HOST_WORKERS,
            mp_context=multiprocessing.get_context("spawn")))
    return HOST_POOL[0]


def host_plain(job):
    """A plain version on the host, in a worker process.  ``job`` is
    (kind, config, inputs, kw): ``kind`` "stream" runs
    ``stream_run_plain``, "call" one ``call_plain``, "windows" the
    per-call host loop over ``call_plain``; ``inputs`` is ("arrays",
    planes, tr, tr_len) as numpy arrays, or ("seed", the arguments of
    :func:`planes_for` after the config) to draw them here.  Returns
    (planes as numpy arrays, status as a numpy array, an int or None,
    seconds)."""
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    from hpa2_tpu_torch.ops.call_run import call_plain, run_windows
    from hpa2_tpu_torch.ops.stream_run import stream_run_plain

    kind, config, inputs, kw = job
    if inputs[0] == "seed":
        state, tr, tr_len, _ = planes_for(config, *inputs[1:], device="cpu")
    else:
        state, tr, tr_len = (
            {f: torch.from_numpy(v) for f, v in inputs[1].items()},
            torch.from_numpy(inputs[2]), torch.from_numpy(inputs[3]))
    t0 = time.perf_counter()
    if kind == "stream":
        want, status = stream_run_plain(config, state, tr, tr_len, **kw)
        status = status.numpy()
    elif kind == "call":
        want, status = call_plain(config, state, tr, tr_len, **kw), None
    else:
        want = {f: v.clone() for f, v in state.items()}
        status = int(run_windows(config, want, tr, tr_len, call=plain_call,
                                 **kw))
    return ({f: v.numpy() for f, v in want.items()}, status,
            time.perf_counter() - t0)


def submit_plain(kind, config, state, tr, tr_len, kw):
    """:func:`host_plain` on copies of card tensors, in the pool."""
    return host_pool().submit(host_plain, (
        kind, config, ("arrays", {f: host_copy(v).numpy()
                                  for f, v in state.items()},
                       host_copy(tr).numpy(), host_copy(tr_len).numpy()),
        kw))


def host_copy(t):
    """A copy of ``t`` in host memory (a copy even of a host tensor)."""
    return t.to("cpu", copy=True)


def on_device(planes, like):
    """Numpy planes from a worker as tensors on ``like``'s device."""
    dev = next(iter(like.values())).device
    return {f: torch.from_numpy(v).to(dev) for f, v in planes.items()}


def cycle_ops(n, system_cycles, messages, instructions):
    """Integer operations a run needs (see ``OPS_NODE_CYCLE``): every
    node's checks in every system-cycle with work, every message handled
    and delivered, every RD/WR issued; from the run's own counters."""
    return (system_cycles * n * OPS_NODE_CYCLE + messages * OPS_MESSAGE
            + instructions * OPS_ISSUE)


def fmt_plain(ms):
    """A plain version's time, or "not run"."""
    return "not run" if ms is None else f"{ms:.1f} ms"


def elapsed_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def time_kernel(cfg, state, tr, tr_len, kw, reps):
    """``reps`` kernel launches, each on fresh copies of ``state`` (the
    kernel updates its planes in place).  Returns the times in ms and
    the planes and stall plane of the last launch."""
    from hpa2_tpu_torch.ops import kernels

    times = []
    for _ in range(reps):
        got = {f: v.clone() for f, v in state.items()}
        status, ms = elapsed_ms(
            lambda: kernels.stream_run(cfg, got, tr, tr_len, **kw))
        times.append(ms)
    return times, got, status


def plane_diff(cfg, snapshots, got, want, packed=False):
    """Largest abs difference per plane of two runs' carried planes."""
    from hpa2_tpu_torch.ops.layout import fields_of

    return {f: int((got[f].long() - want[f].long()).abs().max())
            for f in fields_of(cfg, snapshots, packed)}


def joined_diff(cfg, snapshots, packed_state, state):
    """Largest abs difference per plane of a packed run (its narrow
    planes joined into words) and an unpacked run."""
    from hpa2_tpu_torch.ops.layout import _join_word_planes_np, fields_of

    out = {}
    for f in fields_of(cfg, snapshots):
        if f.endswith(("cachew", "dirw")):
            pre = f[:-len("cachew")] if f.endswith("cachew") else f[:-4]
            words = _join_word_planes_np(*(
                packed_state[pre + g].cpu().numpy()
                for g in ("cvalw", "cmetaw", "dmemw", "dmetaw")))
            joined = words[0] if f.endswith("cachew") else words[1]
            out[f] = int(np.abs(joined.astype(np.int64)
                                - state[f].cpu().numpy()).max())
        else:
            out[f] = int((packed_state[f].long() - state[f].long()).abs().max())
    return out


def check_diff(label, diff):
    bad = [f for f, d in diff.items() if d]
    if bad:
        raise AssertionError(f"{label}: planes differ on {bad}")
    return max(diff.values())


def kernel_vs_plain(label, cfg, b, t, seed, *, snapshots, block, k, window,
                    gate, max_calls, stall, reps=1, packed=False, idle=0,
                    host=False):
    """``reps`` kernel launches and one plain run from the same planes
    (the first ``idle`` lanes of each block without work); every carried
    plane and the stall plane must agree bit for bit, and the stall must
    be as ``stall`` says (True, False, or None for either).  Returns
    (max abs difference, mean kernel ms, plain ms, kernel planes, stall
    plane).  ``host``: the plain version runs in the host pool on the
    same planes, drawn there from the seed, and :func:`settle_compare`
    holds the kernel to it later (the difference and plain ms returned
    here are then 0 and None)."""
    from hpa2_tpu_torch.ops.stream_run import stream_run_plain

    state, tr, tr_len, n_seg = planes_for(cfg, b, t, seed, snapshots, window,
                                          packed, idle, block)
    kw = dict(block=block, k=k, window=window, n_seg=n_seg,
              max_calls=max_calls, gate=gate, snapshots=snapshots,
              packed=packed)
    if host:
        job = host_pool().submit(host_plain, (
            "stream", cfg, ("seed", b, t, seed, snapshots, window, packed,
                            idle, block), kw))
    times, got, status = time_kernel(cfg, state, tr, tr_len, kw, reps)
    ms = sum(times) / reps
    if stall is not None and bool(status.any()) != stall:
        raise AssertionError(
            f"{label}: the kernel {'did not stall' if stall else 'stalled'}")
    line = (f"[compare] {label}: {b} systems x {cfg.num_procs} nodes x {t} "
            f"instrs, cache {cfg.cache_size}, mem {cfg.mem_size}, cap "
            f"{cfg.msg_buffer_size}, block {block}, window {window}, gate "
            f"{gate}, snapshots {snapshots}, packed {packed}: stalled="
            f"{int(status.any())} max_abs_err={{err}} kernel {ms:.3f} ms "
            f"({', '.join(f'{x:.3f}' for x in times)}), plain {{plain}}")
    if host:
        PENDING.append(dict(label=label, cfg=cfg, snapshots=snapshots,
                            packed=packed, got=got, status=status, job=job,
                            line=line))
        return 0, ms, None, got, status
    (want, want_status), plain_ms = elapsed_ms(
        lambda: stream_run_plain(cfg, state, tr, tr_len, **kw))
    diff = plane_diff(cfg, snapshots, got, want, packed)
    diff["status"] = int((status.long() - want_status.long()).abs().max())
    err = max(diff.values())
    print(line.format(err=err, plain=f"{plain_ms:.1f} ms"))
    check_diff(label, diff)
    return err, ms, plain_ms, got, status


def settle_compare():
    """Hold each pending compare case's kernel run to its plain version
    from the host pool (waiting for those still running): every carried
    plane and the stall plane or status word bit for bit.  Returns the
    largest difference of each kernel's cases."""
    t0, err = time.perf_counter(), {"stream_run": 0, "call_run": 0}
    while PENDING:
        case = PENDING.pop(0)
        want, want_status, secs = case["job"].result()
        got, status = case["got"], case["status"]
        diff = plane_diff(case["cfg"], case["snapshots"], got,
                          on_device(want, got), case["packed"])
        if isinstance(status, int):
            diff["status"] = abs(status - want_status)
        else:
            diff["status"] = int((status.long().cpu() - torch.from_numpy(
                want_status).long()).abs().max())
        e = max(diff.values())
        print(case["line"].format(
            err=e, plain=f"{secs * 1e3:.1f} ms on one host core"))
        kern = "call_run" if isinstance(status, int) else "stream_run"
        err[kern] = max(err[kern], check_diff(case["label"], diff))
    print(f"[compare] the host's plain versions: "
          f"{time.perf_counter() - t0:.1f} s waited for")
    return err


@contextlib.contextmanager
def checked_kernels(label):
    """Hold every kernel launch made inside against the plain version:
    ``kernels.stream_run`` and ``kernels.call_run`` are wrapped so that
    each keeps a copy of the planes it is given, launches the kernel as
    usual, runs the plain version on the copy with the same trace
    planes and arguments, and compares every carried plane (and the
    streamed run's stall plane) bit for bit.  A launch on at most
    ``HOST_CHECK_LANES`` lanes keeps a host copy of its inputs and of
    the planes it left, its plain version runs in the host pool, and
    the comparison waits for the end of the block.  The launches are
    the code's own, so the launch counts are unchanged; the time is
    not.  Yields the record: checks per kernel, lanes checked with an
    empty window (idle lanes, ``tr_len`` 0 on every node) and with a
    window that ends early on some node, the checks whose plain
    version ran on the host, the plain versions' seconds, and the
    largest difference."""
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.call_run import call_plain, window_planes
    from hpa2_tpu_torch.ops.stream_run import stream_run_plain

    rec = {"stream_run": 0, "call_run": 0, "idle_lanes": 0,
           "ragged_lanes": 0, "host": 0, "err": 0, "seconds": 0.0}
    launch = {"stream_run": kernels.stream_run,
              "call_run": kernels.call_run}
    pending = []

    def coverage(tl, window):
        rec["idle_lanes"] += int((tl == 0).all(0).sum())
        rec["ragged_lanes"] += int((tl % window != 0).any(0).sum())

    def compare(name, config, kw, got, want, extra=None):
        diff = plane_diff(config, kw["snapshots"], got, want,
                          kw.get("packed", False))
        diff.update(extra or {})
        rec["err"] = max(rec["err"], check_diff(f"{label} {name}", diff))
        rec[name] += 1

    def on_host(name, config, before, state, tr, tr_len, kw, status=None):
        if tr_len.shape[-1] > HOST_CHECK_LANES:
            return False
        pending.append((name, config, kw,
                        {f: host_copy(v) for f, v in state.items()},
                        None if status is None else host_copy(status),
                        submit_plain("stream" if name == "stream_run"
                                     else "call", config, before, tr,
                                     tr_len, kw)))
        return True

    def stream_run(config, state, tr, tr_len, **kw):
        before = {f: v.clone() for f, v in state.items()}
        status = launch["stream_run"](config, state, tr, tr_len, **kw)
        t0 = time.perf_counter()
        if not on_host("stream_run", config, before, state, tr, tr_len, kw,
                       status):
            want, want_status = stream_run_plain(config, before, tr, tr_len,
                                                 **kw)
            stall = int((status.long() - want_status.long()).abs().max())
            compare("stream_run", config, kw, state, want, {"stall": stall})
        coverage(tr_len, kw["window"])
        rec["seconds"] += time.perf_counter() - t0
        return status

    def call_run(config, state, tr, tr_len, *, seg, **kw):
        before = {f: v.clone() for f, v in state.items()}
        launch["call_run"](config, state, tr, tr_len, seg=seg, **kw)
        t0 = time.perf_counter()
        if not on_host("call_run", config, before, state, tr, tr_len,
                       dict(kw, seg=seg)):
            want = call_plain(config, before, tr, tr_len, seg=seg, **kw)
            compare("call_run", config, kw, state, want)
        coverage(window_planes(tr, tr_len, seg, kw["window"])[1],
                 kw["window"])
        rec["seconds"] += time.perf_counter() - t0

    kernels.stream_run, kernels.call_run = stream_run, call_run
    try:
        yield rec
    finally:
        kernels.stream_run = launch["stream_run"]
        kernels.call_run = launch["call_run"]
    for name, config, kw, got, status, job in pending:
        want, want_status, secs = job.result()
        extra = None
        if status is not None:
            extra = {"stall": int((status.long() - torch.from_numpy(
                want_status).long()).abs().max())}
        compare(name, config, kw, got, on_device(want, got), extra)
        rec["host"] += 1
        rec["seconds"] += secs


@contextlib.contextmanager
def timed_launches():
    """A pair of CUDA events around every K2 library launch made inside
    (``kernels.STREAM_RUN.launch``, not the Python wrapper, so the
    wrapper's argument checks and assembly on the host fall outside),
    recorded on the stream and read only afterwards (no host sync); the
    launch count is the code's own.  Yields the list of (start, end)
    pairs."""
    from hpa2_tpu_torch.ops import kernels

    kern = kernels.STREAM_RUN
    launch = kern.launch
    pairs = []

    def timed(*args, device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(device))
        launch(*args, device=device)
        end.record(torch.cuda.current_stream(device))
        pairs.append((start, end))

    kern.launch = timed
    try:
        yield pairs
    finally:
        del kern.launch


def launches_ms(pairs):
    """Device ms of the launches :func:`timed_launches` recorded."""
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs)


def phase_compare():
    """Cases (a)-(e) and (k): the kernel against its plain version at up
    to 8 nodes."""
    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.ops import kernels

    robust = Semantics().robust()
    errs = []
    # The robust cases must complete: the kernel's stall plane is checked
    # before the plain run, so a stall cannot leave the plain version
    # spinning through the whole call budget.
    # (a) the headline geometry, two windows
    cfg = SystemConfig(semantics=robust, **HEADLINE)
    errs.append(kernel_vs_plain("a headline", cfg, 2048, 64, 1,
                                snapshots=False, max_calls=10_000,
                                stall=False, host=True,
                                **HEADLINE_RUN)[0])
    # (b) the `run` command's geometry (4 nodes, cap 256), snapshots on
    cfg = SystemConfig(semantics=robust)
    errs.append(kernel_vs_plain("b run-default", cfg, 256, 32, 2,
                                snapshots=True, block=256, k=128,
                                window=32, gate=True, max_calls=10_000,
                                stall=False, host=True)[0])
    # (c) fixture ("drop") semantics: random traffic livelocks, so the
    # stall bit must agree
    cfg = SystemConfig(msg_buffer_size=16)
    errs.append(kernel_vs_plain("c drop", cfg, 256, 24, 3, snapshots=True,
                                block=64, k=32, window=24, gate=True,
                                max_calls=8, stall=True, host=True)[0])
    # (d) tiny mailboxes: deferred sends and backpressure.  At 8 nodes
    # and 4 slots some random systems deadlock on full mailboxes, so the
    # call budget is short and those blocks report the stall.
    cfg = SystemConfig(num_procs=8, msg_buffer_size=4, semantics=robust)
    errs.append(kernel_vs_plain("d cap4", cfg, 256, 32, 4, snapshots=False,
                                block=32, k=128, window=32, gate=True,
                                max_calls=4, stall=None, host=True)[0])
    # (e) no quiescence gate
    cfg = SystemConfig(semantics=robust, **HEADLINE)
    errs.append(kernel_vs_plain("e gate-off", cfg, 1024, 40, 5,
                                snapshots=False, block=256, k=128,
                                window=32, gate=False, max_calls=10_000,
                                stall=False, host=True)[0])
    # (k) lane blocks above 1,024 at the headline geometry: 2,048 (a
    # cluster of 8 CTAs, the first idle from the start) and the card's
    # largest at the 8-node bound (16 CTAs of 5 rounds)
    errs.append(kernel_vs_plain("k block 2048", cfg, 6144, 32, 6,
                                snapshots=False, block=2048, k=128,
                                window=32, gate=True, max_calls=10_000,
                                stall=False, idle=256, host=True)[0])
    most = kernels.MAX_LANE_BLOCK[8]
    errs.append(kernel_vs_plain(f"k block {most}", cfg, most, 8, 7,
                                snapshots=False, block=most, k=128,
                                window=8, gate=True, max_calls=10_000,
                                stall=False)[0])
    return max(errs)


def phase_wide_compare():
    """Cases (f) split sharer planes against the plain version at 22
    (one window, snapshots), 33 (two windows) and 64 nodes; (g) packed
    planes: the packed kernel against the unpacked kernel at 2,048 x 8
    x 64, and packed x split at 22 nodes against the plain packed
    version and the unpacked kernel (planes joined)."""
    from hpa2_tpu_torch.config import Semantics, SystemConfig

    robust = Semantics().robust()
    errs = []
    cfg22 = SystemConfig(num_procs=22, cache_size=2, mem_size=4,
                         msg_buffer_size=16, semantics=robust)
    errs.append(kernel_vs_plain("f 22 nodes", cfg22, 256, 12, 11,
                                snapshots=True, block=64, k=32, window=12,
                                gate=True, max_calls=10_000, stall=False,
                                host=True)[0])
    cfg33 = SystemConfig(num_procs=33, cache_size=4, mem_size=8,
                         msg_buffer_size=32, semantics=robust)
    errs.append(kernel_vs_plain("f 33 nodes", cfg33, 256, 20, 12,
                                snapshots=False, block=128, k=64, window=10,
                                gate=True, max_calls=10_000, stall=False,
                                host=True)[0])
    cfg64 = SystemConfig(semantics=robust, **WIDE)
    errs.append(kernel_vs_plain("f 64 nodes", cfg64, 512, 8, 13,
                                snapshots=False, block=256, k=64, window=8,
                                gate=True, max_calls=10_000, stall=False,
                                host=True)[0])

    def packed_vs_unpacked(label, cfg, b, t, seed, snapshots, kw, packed_got):
        state, tr, tr_len, n_seg = planes_for(cfg, b, t, seed, snapshots,
                                              kw["window"])
        run = dict(kw, n_seg=n_seg, max_calls=10_000, snapshots=snapshots)
        (ms,), got, status = time_kernel(cfg, state, tr, tr_len, run, 1)
        if packed_got is None:
            pstate = planes_for(cfg, b, t, seed, snapshots, kw["window"],
                                True)[0]
            (pms,), packed_got, pstatus = time_kernel(
                cfg, pstate, tr, tr_len, dict(run, packed=True), 1)
            if bool(pstatus.any()) or bool(status.any()):
                raise AssertionError(f"{label}: a run stalled")
            print(f"[compare] {label}: packed kernel {pms:.3f} ms")
        err = check_diff(label, joined_diff(cfg, snapshots, packed_got, got))
        print(f"[compare] {label}: {b} systems x {cfg.num_procs} nodes x {t}"
              f" instrs, packed kernel against the unpacked kernel "
              f"({ms:.3f} ms), planes joined: max_abs_err={err}")
        return err

    cfg = SystemConfig(semantics=robust, **HEADLINE)
    errs.append(packed_vs_unpacked("g packed 8 nodes", cfg, 2048, 64, 1,
                                   False, HEADLINE_RUN, None))
    kw22 = dict(block=64, k=32, window=12, gate=True)
    err, _, _, got, _ = kernel_vs_plain(
        "g packed 22 nodes", cfg22, 256, 12, 14, snapshots=True,
        max_calls=10_000, stall=False, packed=True, host=True, **kw22)
    errs.append(err)
    errs.append(packed_vs_unpacked("g packed 22 nodes", cfg22, 256, 12, 14,
                                   True, kw22, got))
    return max(errs)


def drive_path(label, cfg, b, t, run, *, packed=False, ref=None,
               probe=()):
    """One path of the port at full width: ``CudaEngine.run()`` with the
    launch counts read around it, then the kernel alone (mean of 3
    launches) on the same inputs, held against the plain version -- or,
    given ``ref`` (the planes of another path already held against the
    plain version on these inputs), against ``ref`` alone, with no
    plain run -- the bytes bound and a lane-block probe (one launch per
    block size)."""
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
    from hpa2_tpu_torch.ops.layout import _SC_CYCLE, _SC_MSGS
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    arrays = gen_uniform_random_arrays(cfg, b, t, seed=0)

    def engine():
        return CudaEngine(cfg, *arrays, block=run["block"],
                          cycles_per_call=run["k"], snapshots=False,
                          trace_window=run["window"], gate=run["gate"],
                          packed=packed)

    engine().run()  # warm-up
    eng = engine()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for kern in kernels.KERNELS:
        kern.launches = 0
    _, run_ms = elapsed_ms(eng.run)
    launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    if launches["stream_run"] == 0 or launches["call_run"] != 0:
        raise AssertionError(
            f"{label}: the streamed kernel did not run alone: {launches}")
    want_instr = int(arrays[3].sum())
    if eng.instructions != want_instr:
        raise AssertionError(
            f"{label}: {eng.instructions} instructions retired of "
            f"{want_instr}")
    peak = torch.cuda.max_memory_allocated()
    sc = eng.state["scalars"].long()
    lane_cycles = int(sc[_SC_CYCLE].sum())

    # the kernel alone, on fresh planes, and the plain version (these
    # launches are not the path's launches)
    if ref is None:
        err, ms, plain_ms, got, _ = kernel_vs_plain(
            label, cfg, b, t, 0, snapshots=False, max_calls=10_000,
            stall=False, reps=3, packed=packed, **run)
    else:
        # equality is transitive: ``ref`` equals the plain version on
        # these inputs, so a plain run here would buy no coverage
        state, tr, tr_len, n_seg = planes_for(cfg, b, t, 0, False,
                                              run["window"], packed)
        kwr = dict(run, n_seg=n_seg, max_calls=10_000, snapshots=False,
                   packed=packed)
        times, got, status = time_kernel(cfg, state, tr, tr_len, kwr, 3)
        ms, plain_ms = sum(times) / 3, None
        if bool(status.any()):
            raise AssertionError(f"{label}: the kernel stalled")
        diff = (joined_diff(cfg, False, got, ref) if packed
                else plane_diff(cfg, False, got, ref))
        err = check_diff(label, diff)
        print(f"[compare] {label}: kernel {ms:.3f} ms "
              f"({', '.join(f'{x:.3f}' for x in times)}), held against "
              f"the checked planes of the unpacked kernel{', joined' if packed else ''}: "
              f"max_abs_err={err} (no plain run)")
    err = max(err, check_diff(label, plane_diff(cfg, False, eng.state, got,
                                                packed)))

    state_bytes = sum(v.numel() * v.element_size()
                      for v in eng.state.values())
    trace_bytes = (eng._tr_full.numel() + eng._tr_len_full.numel()) * 4
    status_bytes = b * 4
    moved = 2 * state_bytes + trace_bytes + status_bytes
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    messages = int(sc[_SC_MSGS].sum())
    ops = cycle_ops(cfg.num_procs, lane_cycles, messages, eng.instructions)
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[{label}] {b} systems x {cfg.num_procs} nodes x {t} instrs "
          f"(cache {cfg.cache_size}, mem {cfg.mem_size}, cap "
          f"{cfg.msg_buffer_size}, block {run['block']}, window "
          f"{run['window']}, k {run['k']}, packed {packed}): status 0, "
          f"{eng.instructions} RD/WR retired, {messages} "
          f"messages, max cycle {eng.cycle}, {lane_cycles} system-cycles")
    print(f"[{label}] engine run {run_ms:.3f} ms "
          f"({eng.instructions / run_ms * 1e3:.4e} RD/WR ops/s), kernel "
          f"{ms:.3f} ms ({eng.instructions / ms * 1e3:.4e} RD/WR ops/s, "
          f"{ms / eng.cycle * 1e3:.3f} us a cycle of the longest system), "
          f"plain {fmt_plain(plain_ms)}, launches {launches}")
    threads = kernels.threads_per_system(cfg)
    geo = kernels.launch_geometry(run["block"], threads)
    print(f"[{label}] bound: bytes {moved} B (state {state_bytes} B read and "
          f"written, traces {trace_bytes} B) / 3.35 TB/s = {bytes_ms:.4f} "
          f"ms; operations {ops} / {SCALAR_OPS_PER_S:.3g} ops/s = "
          f"{ops_ms:.4f} ms; kernel / bound {ms / bound_ms:.1f}; "
          f"{b // run['block']} clusters of {geo[0]} CTAs ({geo[3]} systems "
          f"x {threads} threads, {geo[2]} rounds) on 132 "
          f"SMs; peak device memory {peak} B ({held} B of it held before "
          "the run)")

    # SM fill: the same inputs with other lane blocks (a block is the
    # unit of gating, so each is its own run); one launch each
    if probe:
        state, tr, tr_len, n_seg = planes_for(cfg, b, t, 0, False,
                                              run["window"], packed)
        fill = []
        for blk in probe:
            kwp = dict(run, block=blk, n_seg=n_seg, max_calls=10_000,
                       snapshots=False, packed=packed)
            times, _, status = time_kernel(cfg, state, tr, tr_len, kwp, 1)
            fill.append(f"block {blk} ({b // blk} CTAs) {times[0]:.3f} ms"
                        f"{' STALLED' if status.any() else ''}")
        print(f"[{label}] other lane blocks: {'; '.join(fill)}")
    out = dict(launches=launches, err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms,
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               state=got)
    if ref is not None:
        out["held_to"] = ("the streamed unpacked kernel's planes (held "
                          "to the plain version)")
    return out


def plain_call(cfg, state, tr, tr_len, **kw):
    """One call of the per-call kernel's plain version, in place."""
    from hpa2_tpu_torch.ops.call_run import call_plain

    for f, v in call_plain(cfg, state, tr, tr_len, **kw).items():
        state[f].copy_(v)


def per_call_kernel(cfg, state, tr, tr_len, kw):
    """The per-call kernel under its host loop on fresh copies of
    ``state``, each launch timed by CUDA events.  Returns (per-launch
    ms, planes, status word, host reads of the loop)."""
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.call_run import run_windows

    events = []

    def timed(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        kernels.call_run(*a, **k)
        end.record()
        events.append((start, end))

    got = {f: v.clone() for f, v in state.items()}
    reads = kernels.HOST_SYNCS.count
    status = int(run_windows(cfg, got, tr, tr_len, call=timed, **kw))
    reads = kernels.HOST_SYNCS.count - reads
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events], got, status, reads


def per_call_vs_plain(label, cfg, b, t, seed, *, snapshots, block, k,
                      window, gate, max_calls, stall, packed=False, idle=0,
                      plain=True, host=False):
    """The per-call kernel under its host loop and the same loop over the
    plain version, from the same planes (the first ``idle`` lanes of
    each block without work); every carried plane and the status word
    must agree, and the stall must be as ``stall`` says (True, False, or
    None for either).  ``plain=False`` runs the kernel alone (its
    caller holds the planes against planes already checked); ``host``
    runs the plain loop in the host pool, as :func:`kernel_vs_plain`
    does."""
    from hpa2_tpu_torch.ops.call_run import run_windows

    state, tr, tr_len, n_seg = planes_for(cfg, b, t, seed, snapshots, window,
                                          packed, idle, block)
    kw = dict(block=block, k=k, window=window, n_seg=n_seg,
              max_calls=max_calls, gate=gate, snapshots=snapshots,
              packed=packed)
    if host and plain:
        job = host_pool().submit(host_plain, (
            "windows", cfg, ("seed", b, t, seed, snapshots, window, packed,
                             idle, block), kw))
    times, got, status, reads = per_call_kernel(cfg, state, tr, tr_len, kw)
    if stall is not None and bool(status & 1) != stall:
        raise AssertionError(
            f"{label}: the kernel {'did not stall' if stall else 'stalled'}")
    if not plain:
        print(f"[compare] {label}: {b} systems x {cfg.num_procs} nodes x "
              f"{t} instrs, block {block}, window {window}, k {k}: status "
              f"{status}, {len(times)} launches, {reads} host reads, "
              f"kernel {sum(times):.3f} ms summed over launches (no plain "
              "run)")
        return dict(err=0, ms=sum(times), plain_ms=None,
                    launches=len(times), state=got, status=status,
                    reads=reads)
    line = (f"[compare] {label}: {b} systems x {cfg.num_procs} nodes x {t} "
            f"instrs, cache {cfg.cache_size}, mem {cfg.mem_size}, cap "
            f"{cfg.msg_buffer_size}, block {block}, window {window}, k {k}, "
            f"gate {gate}, snapshots {snapshots}, packed {packed}: status "
            f"{status}, {len(times)} launches, {reads} host reads, "
            f"max_abs_err={{err}} kernel {sum(times):.3f} ms summed over "
            "launches, plain {plain}")
    out = dict(err=0, ms=sum(times), plain_ms=None, launches=len(times),
               state=got, status=status, reads=reads)
    if host:
        PENDING.append(dict(label=label, cfg=cfg, snapshots=snapshots,
                            packed=packed, got=got, status=status, job=job,
                            line=line))
        return out
    want = {f: v.clone() for f, v in state.items()}
    want_status, plain_ms = elapsed_ms(lambda: int(run_windows(
        cfg, want, tr, tr_len, call=plain_call, **kw)))
    diff = plane_diff(cfg, snapshots, got, want, packed)
    diff["status"] = abs(status - want_status)
    err = max(diff.values())
    print(line.format(err=err, plain=f"{plain_ms:.1f} ms"))
    check_diff(label, diff)
    out.update(err=err, plain_ms=plain_ms)
    return out


def phase_call_compare():
    """Case (h): the per-call kernel against its plain version."""
    from hpa2_tpu_torch.config import Semantics, SystemConfig

    robust = Semantics().robust()
    errs = []
    cfg4 = SystemConfig(semantics=robust)
    for gate in (True, False):
        errs.append(per_call_vs_plain(
            f"h 4 nodes gate {gate}", cfg4, 256, 32, 21, snapshots=True,
            block=64, k=32, window=32, gate=gate, max_calls=10_000,
            stall=False, host=True)["err"])
    cfg8 = SystemConfig(semantics=robust, **HEADLINE)
    for w, t, gate in ((7, 20, False), (8, 40, True), (1, 6, True)):
        errs.append(per_call_vs_plain(
            f"h 8 nodes window {w}/{t}", cfg8, 1024, t, 22 + w,
            snapshots=False, block=256, k=32, window=w, gate=gate,
            max_calls=10_000, stall=False, host=True)["err"])
    cfg22 = SystemConfig(num_procs=22, cache_size=2, mem_size=4,
                         msg_buffer_size=16, semantics=robust)
    errs.append(per_call_vs_plain(
        "h 22 nodes", cfg22, 256, 12, 23, snapshots=True, block=64, k=32,
        window=12, gate=True, max_calls=10_000, stall=False,
        host=True)["err"])
    cfg33 = SystemConfig(num_procs=33, cache_size=4, mem_size=8,
                         msg_buffer_size=32, semantics=robust)
    errs.append(per_call_vs_plain(
        "h 33 nodes", cfg33, 256, 12, 24, snapshots=False, block=128, k=64,
        window=6, gate=False, max_calls=10_000, stall=False,
        host=True)["err"])
    errs.append(per_call_vs_plain(
        "h packed 8 nodes", cfg8, 2048, 40, 25, snapshots=False,
        max_calls=10_000, stall=False, packed=True, host=True,
        **HEADLINE_RUN)["err"])
    errs.append(per_call_vs_plain(
        "h packed 22 nodes", cfg22, 256, 12, 26, snapshots=True, block=64,
        k=32, window=12, gate=True, max_calls=10_000, stall=False,
        packed=True, host=True)["err"])
    # 8 nodes, 4 mailbox slots: some systems deadlock, so the budget is
    # short and the stall status must agree
    cfg_cap4 = SystemConfig(num_procs=8, msg_buffer_size=4, semantics=robust)
    errs.append(per_call_vs_plain(
        "h cap4", cfg_cap4, 256, 32, 4, snapshots=False, block=32, k=128,
        window=32, gate=True, max_calls=4, stall=None, host=True)["err"])
    return max(errs)


def phase_team_compare():
    """Cases (i) and (j): lane blocks spread over several CTAs of a
    cluster.  (i) The first CTA of each block has no work from the start
    (its lanes' traces are empty) while the block's others do: it runs
    only because the block's gate is open, and with snapshots on its
    systems take their snapshots in the block's first cycle; streamed at
    8 and 22 nodes and per-call at 8.  (j) 4 mailbox slots and a budget
    of 2 calls: every busy block stalls, streamed and per-call.  Each
    against its plain version bit for bit."""
    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.ops import kernels

    robust = Semantics().robust()
    cfg8 = SystemConfig(semantics=robust, **HEADLINE)
    cfg22 = SystemConfig(num_procs=22, cache_size=2, mem_size=4,
                         msg_buffer_size=16, semantics=robust)
    cap4 = SystemConfig(num_procs=8, msg_buffer_size=4, semantics=robust)
    errs = []
    def geometry(cfg, block):
        return kernels.launch_geometry(block,
                                       kernels.threads_per_system(cfg))[:2]

    for label, cfg, block in (("i idle CTA 8 nodes", cfg8, 512),
                              ("i idle CTA 22 nodes", cfg22, 256)):
        cl, per_cta = geometry(cfg, block)
        err, _, _, got, _ = kernel_vs_plain(
            f"{label} ({cl} CTAs a block)", cfg, 2048, 20, 31,
            snapshots=True, block=block, k=32, window=12, gate=True,
            max_calls=10_000, stall=False, idle=per_cta, host=True)
        idle = got["snap_taken"].reshape(cfg.num_procs, -1, block)
        if not bool(idle[:, :, :per_cta].all()):
            raise AssertionError(f"{label}: idle systems took no snapshot")
        errs.append(err)
    cl, per_cta = geometry(cfg8, 512)
    errs.append(per_call_vs_plain(
        f"i idle CTA per-call 8 nodes ({cl} CTAs a block)", cfg8, 2048, 30,
        32, snapshots=True, block=512, k=32, window=12, gate=True,
        max_calls=10_000, stall=False, idle=per_cta,
        host=True)["err"])
    cl, per_cta = geometry(cap4, 512)
    errs.append(kernel_vs_plain(
        f"j stalled {cl} CTAs a block", cap4, 1024, 32, 33, snapshots=False,
        block=512, k=16, window=32, gate=True, max_calls=2, stall=True,
        idle=per_cta, host=True)[0])
    errs.append(per_call_vs_plain(
        f"j stalled per-call {cl} CTAs a block", cap4, 1024, 32, 34,
        snapshots=True, block=512, k=16, window=32, gate=True, max_calls=2,
        stall=True, idle=per_cta, host=True)["err"])
    return max(errs)


def drive_per_call_path(label, cfg, b, t, run, ref, packed=False,
                        plain=True):
    """The per-call path at full width: ``CudaEngine(stream=False).run()``
    with the counts read around it, then the kernel alone under its
    loop (each launch timed) and (``plain``) the plain version, all held
    against each other and against the streamed run's planes ``ref``
    (which are held against the plain version on the same inputs); the
    bytes bound counts every call: state read and written once, the
    window's traces read once."""
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
    from hpa2_tpu_torch.ops.layout import _SC_CYCLE, _SC_MSGS
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    arrays = gen_uniform_random_arrays(cfg, b, t, seed=0)

    def engine():
        return CudaEngine(cfg, *arrays, block=run["block"],
                          cycles_per_call=run["k"], snapshots=False,
                          trace_window=run["window"], gate=run["gate"],
                          stream=False, packed=packed)

    engine().run()  # warm-up
    eng = engine()
    torch.cuda.synchronize()
    for kern in kernels.KERNELS:
        kern.launches = 0
    syncs = kernels.HOST_SYNCS.count
    _, run_ms = elapsed_ms(eng.run)
    launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    syncs = kernels.HOST_SYNCS.count - syncs
    if launches["call_run"] == 0 or launches["stream_run"] != 0:
        raise AssertionError(f"{label}: launches {launches}")
    if eng.instructions != int(arrays[3].sum()):
        raise AssertionError(f"{label}: not every instruction retired")
    res = per_call_vs_plain(label, cfg, b, t, 0, snapshots=False,
                            max_calls=10_000, stall=False, packed=packed,
                            plain=plain, **run)
    err = max(res["err"],
              check_diff(label, plane_diff(cfg, False, eng.state,
                                           res["state"], packed)),
              check_diff(label, plane_diff(cfg, False, eng.state, ref,
                                           packed)))
    if res["launches"] != launches["call_run"] or \
            syncs != res["reads"] + 1:
        raise AssertionError(
            f"{label}: the engine made {launches['call_run']} launches and "
            f"{syncs} host reads, the kernel alone {res['launches']} and "
            f"{res['reads']} (+1 status read)")
    state_bytes = sum(v.numel() * v.element_size()
                      for v in eng.state.values())
    n, w = cfg.num_procs, run["window"]
    window_bytes = (n * w * b + n * b) * 4
    moved = res["launches"] * (2 * state_bytes + window_bytes)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    lane_cycles = int(eng.state["scalars"][_SC_CYCLE].long().sum())
    ops = cycle_ops(n, lane_cycles,
                    int(eng.state["scalars"][_SC_MSGS].long().sum()),
                    eng.instructions)
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    print(f"[{label}] {b} systems x {n} nodes x {t} instrs (block "
          f"{run['block']}, window {w}, k {run['k']}, packed {packed}, "
          f"stream=False): status 0, {eng.instructions} RD/WR retired, max "
          f"cycle {eng.cycle}, {lane_cycles} system-cycles; planes equal "
          "the streamed run's")
    rate = eng.instructions / run_ms * 1e3
    print(f"[{label}] engine run {run_ms:.3f} ms ({rate:.4e} RD/WR ops/s), "
          f"{launches['call_run']} launches, "
          f"{syncs} host syncs; kernel {res['ms']:.3f} ms summed over "
          f"launches ({res['ms'] / eng.cycle * 1e3:.3f} us a cycle of the "
          f"longest system); plain "
          f"{fmt_plain(res['plain_ms'])}")
    print(f"[{label}] bound: bytes {res['launches']} calls x ({state_bytes} "
          f"B state read and written + {window_bytes} B window) = {moved} B "
          f"/ 3.35 TB/s = {bytes_ms:.4f} ms; operations {ops} / "
          f"{SCALAR_OPS_PER_S:.3g} ops/s = {ops_ms:.4f} ms; kernel / bound "
          f"{res['ms'] / max(bytes_ms, ops_ms):.1f}")
    print(f"[syncs] {label}: {syncs} host syncs in one run() "
          f"({res['reads']} quiescence reads of the per-call loop over "
          f"{launches['call_run']} calls, 1 status read)")
    out = dict(launches=launches, err=err, ms=res["ms"],
               plain_ms=res["plain_ms"],
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               run_ms=run_ms, syncs=syncs)
    if not plain:
        out["held_to"] = ("the streamed kernel's planes (held to the "
                          "plain version)")
    return out


#: bench.py --trace-len-dist zipf at its defaults, at the headline shape
#: but up to 64 instructions a core where it has 128 (a cut of depth, for
#: time)
ZIPF_BATCH, ZIPF_INSTRS, ZIPF_SPREAD, ZIPF_RESIDENT = 32768, 64, 8.0, 8192
#: the scheduled runs whose launches are each held against the plain
#: version: the unscheduled reference, and the resident runs with the
#: streamed and the per-call kernel inside (the other two must equal
#: these plane for plane)
CHECKED_SCHEDULED = ("unscheduled", "resident 8192 fused")


def phase_scheduled():
    """The occupancy scheduler at full width: five runs of the zipf
    workload.  The warm-ups of the runs in ``CHECKED_SCHEDULED`` hold
    every kernel launch against the plain version on the same planes
    and windows (the unscheduled run whole; the scheduled run interval
    by interval, idle lanes and windows that end early included); the
    other runs are held against those runs' planes, which equality
    carries to the plain version.  Then
    the timed runs: the dump
    planes (``cachew``, ``dirw``), ``scalars`` and ``msg_counts`` of
    each equal the unscheduled run's, the fused and host-barrier runs
    with 8,192 resident lanes equal plane for plane, and so do the runs
    with the streamed and the per-call kernel inside."""
    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
    from hpa2_tpu_torch.ops.schedule import Schedule
    from hpa2_tpu_torch.utils.trace import gen_heterogeneous_random_arrays

    cfg = SystemConfig(semantics=Semantics().robust(), **HEADLINE)
    arrays = gen_heterogeneous_random_arrays(
        cfg, ZIPF_BATCH, ZIPF_INSTRS, dist="zipf", spread=ZIPF_SPREAD, seed=0)
    want_instr = int(arrays[3].sum())
    base = dict(block=HEADLINE_RUN["block"],
                cycles_per_call=HEADLINE_RUN["k"], snapshots=False,
                trace_window=HEADLINE_RUN["window"],
                gate=HEADLINE_RUN["gate"])
    runs = [
        ("unscheduled", {}),
        ("fused", dict(schedule=Schedule())),
        ("resident 8192 fused", dict(schedule=Schedule(
            resident=ZIPF_RESIDENT))),
        ("resident 8192 host barriers", dict(schedule=Schedule(
            resident=ZIPF_RESIDENT, fused=False))),
        ("resident 8192 per-call", dict(schedule=Schedule(
            resident=ZIPF_RESIDENT), stream=False)),
    ]
    out, states = {}, {}
    for label, kw in runs:
        # the warm-up; in a checked run every launch is held against
        # the plain version on the same planes and windows
        if label not in CHECKED_SCHEDULED:
            CudaEngine(cfg, *arrays, **base, **kw).run()
            chk = None
        else:
            with checked_kernels(f"scheduled {label}") as chk:
                CudaEngine(cfg, *arrays, **base, **kw).run()
            if chk["stream_run"] + chk["call_run"] == 0 \
                    or chk["ragged_lanes"] == 0 \
                    or ("resident" in label and chk["idle_lanes"] == 0):
                raise AssertionError(
                    f"scheduled {label}: the checks missed a case: {chk}")
            print(f"[compare] scheduled {label}: {chk['stream_run']} "
                  f"streamed and {chk['call_run']} per-call launches held "
                  f"against the plain version on their own planes and "
                  f"windows ({chk['idle_lanes']} idle lanes, "
                  f"{chk['ragged_lanes']} lanes with a window ending early,"
                  f" summed over the checks): max_abs_err={chk['err']}, "
                  f"plain {chk['seconds']:.1f} s")
        eng = CudaEngine(cfg, *arrays, **base, **kw)
        torch.cuda.synchronize()
        for kern in kernels.KERNELS:
            kern.launches = 0
        syncs = kernels.HOST_SYNCS.count
        t0 = time.perf_counter()
        _, ms = elapsed_ms(eng.run)
        host_ms = (time.perf_counter() - t0) * 1e3
        syncs = kernels.HOST_SYNCS.count - syncs
        launches = {kern.name: kern.launches for kern in kernels.KERNELS}
        used = "call_run" if kw.get("stream") is False else "stream_run"
        if launches[used] == 0:
            raise AssertionError(f"scheduled {label}: launches {launches}")
        if eng.instructions != want_instr:
            raise AssertionError(
                f"scheduled {label}: {eng.instructions} of {want_instr} "
                "instructions retired")
        occ = eng.occupancy.as_dict() if eng.occupancy else None
        sched = kw.get("schedule")
        if sched is not None and sched.fused and used == "stream_run" \
                and syncs != 1:
            raise AssertionError(
                f"scheduled {label}: {syncs} host syncs, not 1")
        if sched is not None and not sched.fused \
                and syncs != occ["intervals"]:
            raise AssertionError(
                f"scheduled {label}: {syncs} host syncs over "
                f"{occ['intervals']} intervals")
        if used == "call_run" and syncs != 1 + occ["intervals"] + \
                launches["call_run"]:
            raise AssertionError(
                f"scheduled {label}: {syncs} host syncs, not 1 + "
                f"{occ['intervals']} window-base reads + "
                f"{launches['call_run']} per-call reads")
        states[label] = eng.state
        print(f"[scheduled] {label}: {ZIPF_BATCH} systems x 8 nodes x up to "
              f"{ZIPF_INSTRS} instrs (zipf, spread {ZIPF_SPREAD}, seed 0), "
              f"{eng.instructions} RD/WR retired; run {ms:.3f} ms by CUDA "
              f"events, {host_ms:.3f} ms by the host clock "
              f"({eng.instructions / ms * 1e3:.4e} RD/WR ops/s); launches "
              f"{launches}; {syncs} host syncs; occupancy {occ}")
        out[label] = dict(ms=ms, launches=launches, syncs=syncs,
                          occupancy=occ)
        if chk is not None:
            out[label].update(err=chk["err"],
                              checked=chk["stream_run"] + chk["call_run"])
    ref = states["unscheduled"]
    for label, st in states.items():
        diff = {f: int((st[f].long() - ref[f].long()).abs().max())
                for f in ("cachew", "dirw", "scalars", "msg_counts")}
        check_diff(f"scheduled {label} against unscheduled", diff)
    a, b, c = (states[x] for x in ("resident 8192 fused",
                                   "resident 8192 host barriers",
                                   "resident 8192 per-call"))
    check_diff("scheduled fused against host barriers",
               {f: int((a[f].long() - b[f].long()).abs().max()) for f in a})
    check_diff("scheduled streamed against per-call",
               {f: int((a[f].long() - c[f].long()).abs().max()) for f in a})
    print("[scheduled] dump planes, scalars and msg_counts of every run "
          "equal the unscheduled run's; resident 8192: fused, host-barrier "
          "and per-call runs equal plane for plane")

    # the host's share of the runs above, timed alone: the plan replay
    # of the fused runs, and the host-barrier loop's replay with its
    # window assembly
    from hpa2_tpu_torch.ops.cuda_engine import interval_windows
    from hpa2_tpu_torch.ops.layout import _pack_traces
    from hpa2_tpu_torch.ops.schedule import (
        LaneScheduler, build_plan, segments_needed,
    )

    w, block = HEADLINE_RUN["window"], HEADLINE_RUN["block"]
    tr = _pack_traces(cfg, *arrays)
    tl = np.ascontiguousarray(arrays[3].T)
    nseg = segments_needed(tl, w)
    replay = {}
    for resident in (ZIPF_BATCH, ZIPF_RESIDENT):
        t0 = time.perf_counter()
        build_plan(nseg, resident=resident, block=block)
        replay[resident] = (time.perf_counter() - t0) * 1e3
    sched = LaneScheduler(nseg, resident=ZIPF_RESIDENT, block=block)
    t0 = time.perf_counter()
    assemble = 0.0
    while not sched.done():
        live = sched.begin_interval()
        t1 = time.perf_counter()
        interval_windows(tr, tl, sched.lane_sys, sched.lane_seg, live, w)
        assemble += time.perf_counter() - t1
        sched.end_interval()
    loop_ms = (time.perf_counter() - t0) * 1e3
    print(f"[scheduled] host work timed alone: plan replay "
          f"{replay[ZIPF_BATCH]:.1f} ms (all resident), "
          f"{replay[ZIPF_RESIDENT]:.1f} ms (8192 resident); host-barrier "
          f"loop {loop_ms:.1f} ms over {sched.stats.intervals} intervals, "
          f"{assemble * 1e3:.1f} ms of it window assembly")
    out["host"] = dict(replay_all=replay[ZIPF_BATCH],
                       replay_resident=replay[ZIPF_RESIDENT],
                       host_barrier_loop=loop_ms, assembly=assemble * 1e3)
    return out


def phase_session():
    """A resident-lane session (512 zipf systems through 256 lanes,
    windows of 16) on the card, with the streamed and the per-call kernel: a
    first pass holds every launch against the plain version, then a
    second pass against the one-shot run: every harvested system's
    planes equal its one-shot columns, the resident planes keep their
    storage, and every compile count is 1."""
    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine, interval_windows
    from hpa2_tpu_torch.ops.layout import _pack_traces
    from hpa2_tpu_torch.ops.schedule import LaneScheduler, segments_needed
    from hpa2_tpu_torch.ops.session import CudaLaneSession
    from hpa2_tpu_torch.utils.trace import gen_heterogeneous_random_arrays

    cfg = SystemConfig(semantics=Semantics().robust(), **HEADLINE)
    b, t, w, r, block, k = 512, 64, 16, 256, 128, 64
    # spread 5: lengths are multiples of 13, so windows end early
    arrays = gen_heterogeneous_random_arrays(cfg, b, t, dist="zipf",
                                             spread=5.0, seed=5)
    tr = _pack_traces(cfg, *arrays)
    tl = np.ascontiguousarray(arrays[3].T)
    one_shot = CudaEngine(cfg, *arrays, block=block, cycles_per_call=k,
                          snapshots=False, trace_window=w).run()

    def serve(stream):
        """One session over the whole workload: (session, harvested
        columns by system, scheduler, plane pointers at the start, host
        ms)."""
        sess = CudaLaneSession(cfg, r, w, block=block, cycles_per_call=k,
                               stream=stream)
        ptrs = {f: v.data_ptr() for f, v in sess.state.items()}
        sched = LaneScheduler(segments_needed(tl, w), resident=r,
                              block=block)
        harvested, pending = {}, None
        t0 = time.perf_counter()
        while not sched.done():
            live = sched.begin_interval()
            status = sess.advance(*sess.stage(*interval_windows(
                tr, tl, sched.lane_sys, sched.lane_seg, live, w)))
            plan = sched.end_interval()
            for lane, s in plan.finished:
                harvested[s] = sess.harvest(lane)
            if not plan.trivial:
                perm = plan.perm if plan.perm is not None else np.arange(r)
                reset = np.zeros(r, bool)
                reset[[lane for lane, _ in plan.admitted]] = True
                sess.barrier(perm, reset)
            if pending is not None:
                sess.check(pending)  # one interval behind
            pending = status
        sess.check(pending)
        return sess, harvested, sched, ptrs, (time.perf_counter() - t0) * 1e3

    out = {}
    for stream in (True, False):
        # first pass: every launch held against the plain version
        with checked_kernels(f"session stream={stream}") as chk:
            serve(stream)
        if chk["idle_lanes"] == 0 or chk["ragged_lanes"] == 0:
            raise AssertionError(f"session: the checks missed a case: {chk}")
        print(f"[compare] session stream={stream}: {chk['stream_run']} "
              f"streamed and {chk['call_run']} per-call launches held "
              f"against the plain version on their own planes and windows "
              f"({chk['idle_lanes']} idle lanes, {chk['ragged_lanes']} "
              f"lanes with a window ending early): "
              f"max_abs_err={chk['err']}")
        for kern in kernels.KERNELS:
            kern.launches = 0
        sess, harvested, sched, ptrs, host_ms = serve(stream)
        launches = {kern.name: kern.launches for kern in kernels.KERNELS}
        used = "stream_run" if stream else "call_run"
        if launches[used] == 0:
            raise AssertionError(f"session: launches {launches}")
        if sorted(harvested) != list(range(b)):
            raise AssertionError("session: not every system was harvested")
        err = 0
        # the one-shot run goes on clearing pc at window bases that a
        # short system's session never reaches, so nsw is not compared
        cols = [sess.columns_of(harvested[s]) for s in range(b)]
        for f in ("cachew", "dirw", "scalars", "msg_counts"):
            got = np.concatenate([c[f] for c in cols], axis=-1)
            want = one_shot.state[f].cpu().numpy()
            err = max(err, check_diff(
                f"session stream={stream} plane {f}",
                {f: int(np.abs(got.astype(np.int64)
                               - want.astype(np.int64)).max())}))
        if {f: v.data_ptr() for f, v in sess.state.items()} != ptrs:
            raise AssertionError("session: the resident planes moved")
        counts = sess.compile_counts()
        if set(counts.values()) != {1}:
            raise AssertionError(f"session: compile counts {counts}")
        occ = sched.stats.as_dict()
        print(f"[session] stream={stream}: {b} systems x 8 nodes x up to {t} "
              f"instrs through {r} resident lanes, {occ['intervals']} "
              f"intervals, {occ['admissions']} admissions, "
              f"{occ['compactions']} compactions; {host_ms:.1f} ms by the "
              f"host clock; launches {launches}; every harvested system's "
              f"dump planes, scalars and msg_counts equal the one-shot "
              f"run's (max_abs_err={err}); "
              f"resident planes kept their storage; compile counts {counts}")
        out[stream] = dict(launches=launches, err=max(err, chk["err"]),
                           checked=chk["stream_run"] + chk["call_run"])
    return out


#: the serving geometry ``bench.py`` uses on an accelerator
#: (``_serve_knobs`` at bench.py:538-556, ``serve_child_main`` at
#: :559-690, on ``_bench_config()``): zipf-length jobs (spread 4, seed 0)
#: through 4,096 resident lanes; cut in depth for time: 8,192 jobs where
#: bench.py's feed has 16,384, and of up to 64 instructions a core where
#: it has 128
SERVE = dict(resident=4096, window=32, block=512, policy="fcfs",
             backend="pallas")
SERVE_JOBS, SERVE_INSTRS = 8192, 64


def serve_line(label, st, card, extra=""):
    """One ``[serve]`` line of a run's stats, with the card."""
    d = st.as_dict()
    occ, ph, lat = d["occupancy"], d["phases"], d["latency_s"]
    print(f"[serve] {label}: {d['jobs_completed']} jobs, "
          f"{occ['intervals']} intervals, {occ['admissions']} admissions, "
          f"{occ['compactions']} compactions; {d['instructions']} RD/WR in "
          f"{st.wall_s:.6f} s wall: {st.ops_per_s:.1f} RD/WR ops/s "
          f"sustained; host_staging_s {st.host_staging_s:.6f}, "
          f"device_wait_s {st.device_wait_s:.6f}, readback_s "
          f"{st.readback_s:.6f}; latency p50 {lat['p50']} s, p99 "
          f"{lat['p99']} s; compile counts {d['compile_counts']}{extra} "
          f"({card})")


def phase_serve(card):
    """Always-on serving on the card through ``hpa2_tpu_torch.serving``
    at ``bench.py``'s accelerator geometry (``SERVE``): a checked pass at
    that geometry on 8,192 jobs (every K2 launch held against the plain
    version), a warm-up, the pipelined run (the main path: launches counted from 0),
    the serial run, a Poisson-arrival run at 60% of the pipelined
    capacity, a framed-wire run with two clients, and the ``serve``
    command.  Every served job's dumps (and, untimed, counters) must
    equal the port's one-shot scheduled run's."""
    import threading

    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
    from hpa2_tpu_torch.ops.layout import (
        _SC_CYCLE, _SC_INSTR, _SC_MSGS, decode_dumps,
    )
    from hpa2_tpu_torch.ops.schedule import Schedule
    from hpa2_tpu_torch.service import WireClient, WireJobSource
    from hpa2_tpu_torch.serving import (
        ListJobSource, build_serving, job_to_record, poisson_arrivals,
        serve, synthetic_jobs,
    )
    from hpa2_tpu_torch.utils.dump import format_processor_state

    cfg = SystemConfig(semantics=Semantics().robust(), **HEADLINE)

    def feed(count, seed, spread=4.0, arrivals=None):
        return synthetic_jobs(cfg, count, SERVE_INSTRS, seed=seed,
                              dist="zipf", spread=spread, arrivals=arrivals)

    # 1. the checked pass, at the main path's geometry (SERVE) on twice
    # the resident lanes' worth of jobs; spread 5 makes lengths multiples
    # of 13, so windows of 32 end early, and the feed's tail leaves lanes
    # idle
    checked_jobs = 2 * SERVE["resident"]
    with checked_kernels("serve") as chk:
        _, st = serve(cfg, ListJobSource(feed(checked_jobs, 3, spread=5.0)),
                      overlap=True, **SERVE)
    if chk["stream_run"] == 0 or chk["idle_lanes"] == 0 \
            or chk["ragged_lanes"] == 0:
        raise AssertionError(f"serve: the checks missed a case: {chk}")
    print(f"[compare] serve: {checked_jobs} jobs through "
          f"{SERVE['resident']} lanes (block {SERVE['block']}, window "
          f"{SERVE['window']}, pipelined): {chk['stream_run']} K2 launches "
          f"held against the plain version on their own planes and windows "
          f"({chk['idle_lanes']} idle lanes, {chk['ragged_lanes']} lanes "
          f"with a window ending early): max_abs_err={chk['err']}; "
          f"{st.occupancy['intervals']} intervals, plain "
          f"{chk['seconds']:.1f} s")

    # the reference: the port's one-shot scheduled run of the same jobs
    jobs = feed(SERVE_JOBS, 0)
    arrays = [np.stack([getattr(j, f) for j in jobs])
              for f in ("tr_op", "tr_addr", "tr_val", "tr_len")]
    t0 = time.perf_counter()
    ref = CudaEngine(cfg, *arrays, block=SERVE["block"],
                     trace_window=SERVE["window"], snapshots=False,
                     schedule=Schedule(resident=SERVE["resident"],
                                       fused=False)).run()
    ref_s = time.perf_counter() - t0
    cw, dw = ref._word_planes()
    sc = ref.state["scalars"].cpu().numpy()
    want = {j.job_id: decode_dumps(cfg, cw, dw, s)
            for s, j in enumerate(jobs)}
    counters = {j.job_id: {"instructions": int(sc[_SC_INSTR, s]),
                           "cycles": int(sc[_SC_CYCLE, s]),
                           "messages": int(sc[_SC_MSGS, s])}
                for s, j in enumerate(jobs)}

    def check(label, results, ids, with_counters=True):
        if sorted(r.job_id for r in results) != sorted(ids):
            raise AssertionError(f"serve {label}: jobs served {len(results)}"
                                 f" of {len(ids)}, or some twice")
        for r in results:
            if r.dumps != want[r.job_id]:
                raise AssertionError(f"serve {label}: {r.job_id}'s dumps "
                                     "differ from the one-shot run's")
            if with_counters and r.counters != counters[r.job_id]:
                raise AssertionError(
                    f"serve {label}: {r.job_id}'s counters {r.counters} "
                    f"differ from the one-shot run's {counters[r.job_id]}")

    # 2. warm-up, then the pipelined run: the main path
    serve(cfg, ListJobSource(feed(2 * SERVE["resident"], 99)), **SERVE)
    drv = build_serving(cfg, ListJobSource(jobs), overlap=True, **SERVE)
    ptrs = {f: v.data_ptr() for f, v in drv.session.state.items()}
    for kern in kernels.KERNELS:
        kern.launches = 0
    syncs = kernels.HOST_SYNCS.count
    with timed_launches() as pairs:
        results, pipelined = drv.run()
    launches = {kern.name: kern.launches for kern in kernels.KERNELS}
    syncs = kernels.HOST_SYNCS.count - syncs
    k2_ms = launches_ms(pairs)
    check("pipelined", results, want)
    intervals = pipelined.occupancy["intervals"]
    if launches["stream_run"] != intervals or launches["call_run"]:
        raise AssertionError(f"serve: launches {launches} over {intervals} "
                             "intervals")
    if set(pipelined.compile_counts.values()) != {1}:
        raise AssertionError(f"serve: compile counts "
                             f"{pipelined.compile_counts}")
    if {f: v.data_ptr() for f, v in drv.session.state.items()} != ptrs:
        raise AssertionError("serve: the resident planes moved")
    # K2's bound over the run: each launch reads and writes the resident
    # planes once and reads its window; the operations the jobs' own
    # counters say they needed
    n, r = cfg.num_procs, SERVE["resident"]
    state_bytes = sum(v.numel() * v.element_size()
                      for v in drv.session.state.values())
    moved = intervals * (2 * state_bytes
                         + (n * SERVE["window"] * r + n * r + 1) * 4)
    ops = cycle_ops(n, *(sum(res.counters[k] for res in results)
                         for k in ("cycles", "messages", "instructions")))
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    serve_line("pipelined", pipelined, card,
               f"; launches {launches}; {syncs} host syncs; K2 "
               f"{k2_ms:.3f} ms on the card over the {intervals} launches "
               f"(device idle {1 - k2_ms / 1e3 / pipelined.wall_s:.4f} of "
               f"the wall), bound {bound_ms:.4f} ms by {bound_by} (bytes "
               f"{moved} B = {bytes_ms:.4f} ms, operations {ops} = "
               f"{ops_ms:.4f} ms)")
    print(f"[serve] one-shot reference (CudaEngine, Schedule(resident="
          f"{SERVE['resident']}, fused=False), block {SERVE['block']}, "
          f"window {SERVE['window']}): {ref_s:.3f} s; every served job's "
          "dumps and counters equal its own; the resident planes kept "
          "their storage")

    # 3. the serial baseline on the same feed, in turns with the
    # pipelined run (pipelined, serial, serial, pipelined): the host
    # clock's spread decides what a difference means
    walls = {True: [pipelined.wall_s], False: []}
    serial = None
    for overlap in (False, False, True):
        with timed_launches() as pairs:
            res, st = serve(cfg, ListJobSource(jobs), overlap=overlap,
                            **SERVE)
        check("pipelined" if overlap else "serial", res, want)
        walls[overlap].append(st.wall_s)
        if serial is None:
            serial = st
            serve_line("serial", st, card,
                       f"; K2 {launches_ms(pairs):.3f} ms on the card")
    hidden_s = max(0.0, serial.wall_s - pipelined.wall_s)
    frac = (min(1.0, hidden_s / serial.host_staging_s)
            if serial.host_staging_s > 0 else 0.0)
    print(f"[serve] overlap: pipelined {pipelined.wall_s:.6f} s, serial "
          f"{serial.wall_s:.6f} s: hidden_s {hidden_s:.6f}, "
          f"staging_hidden_frac {frac:.3f}; in turns (pipelined, serial, "
          f"serial, pipelined) pipelined walls "
          f"{', '.join(f'{w:.6f}' for w in walls[True])} s, serial walls "
          f"{', '.join(f'{w:.6f}' for w in walls[False])} s ({card})")

    # 4. Poisson arrivals at 60% of the pipelined capacity
    rate = 0.6 * pipelined.jobs_completed / pipelined.wall_s
    timed = feed(SERVE_JOBS, 0, arrivals=poisson_arrivals(SERVE_JOBS, rate,
                                                          seed=1))
    results_p, poisson = serve(cfg, ListJobSource(timed, timed=True),
                               **SERVE)
    check("poisson", results_p, want, with_counters=False)
    serve_line(f"poisson at {rate:.1f} jobs/s", poisson, card)

    # 5. the framed wire: 512 jobs from two clients on 127.0.0.1
    wire_jobs = jobs[:512]
    recs = [job_to_record(j) for j in wire_jobs]
    src = WireJobSource(cfg, "127.0.0.1", 0)
    acks, got, errors = {}, {}, []

    def client(k, mine):
        try:
            with WireClient(*src.address, timeout_s=120.0) as cli:
                acks[k] = [cli.submit(r) for r in mine]
                got[k] = cli.finish()
        except Exception as e:  # reported below, never passed over
            errors.append(f"client {k}: {e!r}")

    halves = (recs[:256], recs[256:])
    threads = [threading.Thread(target=client, args=(k, h), daemon=True)
               for k, h in enumerate(halves)]
    for t in threads:
        t.start()
    try:
        results_w, wire = serve(cfg, src, emit=src.deliver, resident=512,
                                window=SERVE["window"], block=128)
    finally:
        src.close()
    for t in threads:
        t.join(timeout=120)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve wire: clients failed: {errors}")
    check("wire", results_w, [j.job_id for j in wire_jobs],
          with_counters=False)
    for k, mine in enumerate(halves):
        seqs = [a["seq"] for a in acks[k]]
        if seqs != sorted(seqs) or [a["id"] for a in acks[k]] != [
                r["id"] for r in mine]:
            raise AssertionError(f"serve wire: client {k}'s acks out of "
                                 "order")
        if sorted(r["id"] for r in got[k]) != sorted(r["id"] for r in mine):
            raise AssertionError(f"serve wire: client {k}'s results are not"
                                 " its jobs, each once")
    if sorted(a["seq"] for k in acks for a in acks[k]) != list(range(512)):
        raise AssertionError("serve wire: the ack seqs are not 0..511")
    serve_line("wire, two clients", wire, card,
               "; every result arrived once, acks in seq order")

    # 6. the serve command on a jobs file
    work = ROOT / "hpa2_tpu_torch" / "build" / "smoke_serve"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    path = work / "jobs.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs[:64]))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run(
        [sys.executable, "-m", "hpa2_tpu_torch", "serve", str(path),
         "--nodes", "8", "--msg-buffer-size", "16", "--robust",
         "--resident", "64", "--window", str(SERVE["window"]), "--block",
         "64", "--immediate", "--out", str(work / "out")],
        capture_output=True, text=True, env=env, timeout=600, cwd=str(work))
    if proc.returncode != 0:
        raise AssertionError(f"serve command exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    cli_stats = json.loads(proc.stdout.strip().splitlines()[-1])
    files = 0
    for j in wire_jobs[:64]:
        for d in want[j.job_id]:
            f = work / "out" / j.job_id / f"core_{d.proc_id}_output.txt"
            if f.read_text() != format_processor_state(d, cfg):
                raise AssertionError(f"serve command: {f} differs from the "
                                     "one-shot run's dump")
            files += 1
    print(f"[serve] python -m hpa2_tpu_torch serve (64 jobs): {files} dump "
          f"files equal the one-shot run's; jobs_completed "
          f"{cli_stats['jobs_completed']}, compile counts "
          f"{cli_stats['compile_counts']}")
    return dict(launches=launches, checked=chk["stream_run"],
                err=chk["err"], wall_ms=pipelined.wall_s * 1e3, ms=k2_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------------------
# [general]: the general engine (ops/engine.py, ops/step.py) on the card


#: bench.py:_bench_config (l.74-82): 8 nodes, robust, cache 4, memory
#: 16, 16-deep mailboxes, elision on; 128 uniform-random instructions a
#: core, seed 0
GENERAL = dict(num_procs=8, msg_buffer_size=16)
GENERAL_INSTRS = 128
#: the depth of ``[general]``'s runs: 64 instructions a core where
#: bench.py has 128 (a cut for time; the scheduled, serving and
#: recovery phases keep GENERAL_INSTRS)
GENERAL_RUN_INSTRS = 64
GENERAL_SYSTEMS = 4096
#: part (b): each variant at 1,024 systems, 32 of them also on the CPU
VARIANT_SYSTEMS, VARIANT_CPU = 1024, 32
GENERAL_VARIANTS = {
    "moesi": dict(protocol="moesi"),
    "mesif": dict(protocol="mesif"),
    "limited:2": dict(directory_format="limited:2"),
    "coarse:4": dict(directory_format="coarse:4"),
    "mesh2d multicast": dict(topology="mesh2d", multicast=True),
    "torus2d combining": dict(topology="torus2d", combining=True),
    "hierarchical": dict(topology="hierarchical"),
    # bench.py:517-521, the fault mix of every bench artifact
    "faults": dict(fault=dict(drop=0.2, duplicate=0.05, reorder=0.05,
                              delay=0.1, seed=7)),
}
#: part (c): scripts/scale_runs.py:265-276, 64 nodes x 64 instructions
WIDE_GENERAL_SYSTEMS = 256
#: part (d): every copy on edge 1 -> 0 drops
SEVERED = {"severed": dict(fault=dict(drop=1.0, edge_sender=1,
                                      edge_receiver=0, seed=1))}
#: per-system fields a batch of other systems changes: the loop's cycle
#: count is batch-global, the key splits once a cycle, and the jumps of
#: elision are the minimum over the batch
BATCH_GLOBAL = ("cycle", "rng_key", "n_elided", "n_multi_hit")


def general_config(variant=None, elide=True, **over):
    """The headline configuration of the general engine, with a
    variant's protocol, directory format, topology or faults."""
    from hpa2_tpu_torch.config import (
        FaultModel, InterconnectConfig, Semantics, SystemConfig,
    )

    kw = dict(GENERAL, elide=elide, semantics=Semantics().robust())
    kw.update(over)
    v = dict(GENERAL_VARIANTS.get(variant) or SEVERED.get(variant) or {})
    ic = {k: v.pop(k) for k in ("topology", "multicast", "combining")
          if k in v}
    if "fault" in v:
        ic["fault"] = FaultModel(**v.pop("fault"))
    return SystemConfig(interconnect=InterconnectConfig(**ic), **kw, **v)


def general_cpu_reference(job):
    """One CPU run of the general engine, in a worker process: the first
    ``b`` systems of the full batch's arrays, through ``BatchTorchEngine``
    (``engine=True``) or the batch loop on ``init_state_batched``.  Returns
    the state as numpy arrays, or the stall diagnostic's fields."""
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    from hpa2_tpu_torch.convert import sim_state_to_numpy
    from hpa2_tpu_torch.ops.engine import BatchTorchEngine, build_batched_run
    from hpa2_tpu_torch.ops.state import init_state_batched
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    variant, elide, full, b, t, over, engine, watchdog = job
    cfg = general_config(variant, elide, **over)
    arrays = [a[:b] for a in gen_uniform_random_arrays(cfg, full, t, seed=0)]
    t0 = time.perf_counter()
    if engine:
        eng = BatchTorchEngine(cfg, arrays_to_traces(arrays),
                               watchdog_cycles=watchdog, device="cpu")
        try:
            eng.run()
        except Exception as e:  # the severed edge's diagnostic is the
            # result; it travels back as its fields
            return dict(error=type(e).__name__, **{
                f: getattr(e, f, None) for f in DIAG_FIELDS})
        st = eng.state
    else:
        st = build_batched_run(cfg)(init_state_batched(cfg, *arrays,
                                                       device="cpu"))
    out = sim_state_to_numpy(st)
    out["seconds"] = time.perf_counter() - t0
    return out


DIAG_FIELDS = ("reason", "cycle", "mailbox_depths", "waiting", "blocked",
               "line_states", "recent_msgs", "invariant_violations",
               "counters")


def arrays_to_traces(arrays):
    """``[B, N, T]`` trace arrays -> Instr lists per system."""
    from hpa2_tpu_torch.models.protocol import Instr

    op, addr, val, length = arrays
    return [[[Instr("W", int(a), int(v)) if o == 1 else Instr("R", int(a))
              for o, a, v in zip(op[s, i, :length[s, i]],
                                 addr[s, i, :length[s, i]],
                                 val[s, i, :length[s, i]])]
             for i in range(op.shape[1])] for s in range(op.shape[0])]


def state_err(label, got, want, fields=None):
    """Largest abs difference of two states' fields (numpy dicts);
    raises unless 0."""
    fields = fields or [f for f in want if f != "seconds"]
    diff = {f: int(np.abs(got[f].astype(np.int64)
                          - want[f].astype(np.int64)).max())
            if got[f].shape == want[f].shape else -1 for f in fields}
    bad = [f for f, d in diff.items() if d]
    if bad:
        raise AssertionError(f"{label}: fields differ: {bad}")
    return max(diff.values())


def k2_planes_as_arrays(cfg, state):
    """CudaEngine's (unpacked) planes as [B, N, ...] arrays of the
    general engine's fields: memory, directory state and sharers (one
    int per entry), cache address, value and state, live and snapshot,
    and the per-system counters."""
    from hpa2_tpu_torch.ops.layout import (
        _ADDR_MASK, _CW_ADDR_SHIFT, _CW_VAL_SHIFT, _DW_SH_SHIFT,
        _DW_STATE_SHIFT, _SC_EV, _SC_INSTR, _SC_INV, _SC_MSGS, _SC_RH,
        _SC_RM, _SC_WH, _SC_WM, _SPLIT_BPW, _split_sw,
    )

    np_ = {f: v.cpu().numpy().astype(np.int64) for f, v in state.items()}
    sw = _split_sw(cfg)
    out = {}
    for pre in ("", "snap_"):
        c = np.moveaxis(np_[pre + "cachew"], -1, 0)
        d = np.moveaxis(np_[pre + "dirw"], -1, 0)
        if sw:
            sh = sum(np.moveaxis(np_[f"{pre}dirs{w}"], -1, 0)
                     << (w * _SPLIT_BPW) for w in range(sw))
        else:
            sh = (d >> _DW_SH_SHIFT) & ((1 << cfg.num_procs) - 1)
        out.update({
            pre + "mem": d & 0xFF,
            pre + "dir_state": (d >> _DW_STATE_SHIFT) & 3,
            pre + "dir_sharers": sh,
            pre + "cache_addr": ((c >> _CW_ADDR_SHIFT) & _ADDR_MASK) - 1,
            pre + "cache_val": (c >> _CW_VAL_SHIFT) & 0xFF,
            pre + "cache_state": c & 3,
        })
    sc = np_["scalars"]
    for f, row in (("n_instr", _SC_INSTR), ("n_msgs", _SC_MSGS),
                   ("n_read_hits", _SC_RH), ("n_read_miss", _SC_RM),
                   ("n_write_hits", _SC_WH), ("n_write_miss", _SC_WM),
                   ("n_evictions", _SC_EV), ("n_invalidations", _SC_INV)):
        out[f] = sc[row]
    out["msg_counts"] = np_["msg_counts"].T
    return out


def general_as_k2_arrays(st):
    """The general engine's state (numpy dict) in the same form."""
    out = {}
    for pre in ("", "snap_"):
        words = st[pre + "dir_sharers"].astype(np.int64) & 0xFFFFFFFF
        out[pre + "dir_sharers"] = sum(
            words[..., w] << (32 * w) for w in range(words.shape[-1]))
        for f in ("mem", "dir_state", "cache_addr", "cache_val",
                  "cache_state"):
            out[pre + f] = st[pre + f]
    for f in ("n_instr", "n_msgs", "n_read_hits", "n_read_miss",
              "n_write_hits", "n_write_miss", "n_evictions",
              "n_invalidations", "msg_counts"):
        out[f] = st[f]
    return out


def run_general(label, cfg, arrays, card, reps=1):
    """The batch loop on the card from ``init_state_batched``: the
    loop's graph captured, then ``reps`` timed runs (CUDA events).  Prints ms, cycles, device steps, RD/WR ops/s, launches a
    chunk, chunks and host syncs; returns the last state as numpy."""
    from hpa2_tpu_torch.convert import sim_state_to_numpy
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.engine import build_batched_run
    from hpa2_tpu_torch.ops.state import init_state_batched

    st = init_state_batched(cfg, *arrays, device="cuda")
    run = build_batched_run(cfg)
    t0 = time.perf_counter()
    run.prepare(st)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        syncs = kernels.HOST_SYNCS.count
        out, ms = elapsed_ms(lambda: run(st))
        syncs = kernels.HOST_SYNCS.count - syncs
        times.append(ms)
    ms = min(times)
    cycles = int(out.cycle.max())
    steps = cycles - int(out.n_elided.max())
    instrs = int(out.n_instr.sum())
    b, n = arrays[0].shape[:2]
    if instrs != int(arrays[3].sum()):
        raise AssertionError(f"{label}: {instrs} RD/WR retired of "
                             f"{int(arrays[3].sum())}")
    print(f"[general] {label}: {b} systems x {n} nodes x "
          f"{arrays[0].shape[2]} instrs: {ms:.3f} ms "
          f"({', '.join(f'{x:.3f}' for x in times)}; the graph's capture "
          f"before them {capture_s:.3f} s), {cycles} cycles, {steps} device "
          f"steps ({cycles - steps} elided), {ms / max(steps, 1):.4f} ms a "
          f"step, {instrs / ms * 1e3:.4e} RD/WR ops/s, "
          f"{run.launches_per_chunk} launches a chunk of {run.chunk} steps, "
          f"{run.chunks} chunks, {syncs} host syncs, {card}")
    return sim_state_to_numpy(out), dict(ms=ms, cycles=cycles, steps=steps,
                                         instrs=instrs, run=run)


def k2_cross_check(label, cfg, arrays, got, block):
    """``CudaEngine`` (K2, snapshots on) on the same arrays, timed after
    a warm-up; the general engine's dumps, snapshots and per-system
    counters must equal its planes, and its cycle K2's longest
    system's.  Returns (max abs err, K2 ms, K2 launches)."""
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine

    def engine():
        return CudaEngine(cfg, *arrays, block=block, snapshots=True,
                          device="cuda")

    engine().run()
    eng = engine()
    for kern in kernels.KERNELS:
        kern.launches = 0
    _, ms = elapsed_ms(eng.run)
    launches = kernels.STREAM_RUN.launches
    if launches == 0:
        raise AssertionError(f"{label}: K2 never launched")
    err = state_err(f"{label} against K2", general_as_k2_arrays(got),
                    k2_planes_as_arrays(cfg, eng.state))
    if int(got["cycle"].max()) != eng.cycle:
        raise AssertionError(f"{label}: cycle {int(got['cycle'].max())} "
                             f"against K2's {eng.cycle}")
    print(f"[compare] {label}: against CudaEngine (K2, snapshots on, block "
          f"{block}) on the same arrays: dumps, snapshots and per-system "
          f"counters of {arrays[0].shape[0]} systems equal, cycle "
          f"{eng.cycle} equal, max_abs_err={err}; K2 {ms:.3f} ms "
          f"({eng.instructions / ms * 1e3:.4e} RD/WR ops/s, {launches} "
          "launches)")
    return err, ms, launches


def phase_general(card):
    """The general engine on the card at bench.py's headline
    configuration: (a) MESI/full/ideal at 4,096 systems, elision on and
    off, held against K2 on the same arrays and against the CPU on 64
    systems; (b) every protocol, directory format, topology and the
    fault mix at 1,024 systems, held bit for bit against the CPU on 32
    of them; (c) the 64-node configuration at 256 systems against K2;
    (d) a severed edge that must raise StallDiagnostic on the card as on
    the CPU; and the ``run``/``bench --backend jax`` commands.  The CPU
    references run in worker processes while the card works."""
    import concurrent.futures
    import multiprocessing

    t_full = GENERAL_RUN_INSTRS
    jobs = {}
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=4, mp_context=multiprocessing.get_context("spawn"))
    try:
        for elide in (True, False):
            jobs["a", elide] = pool.submit(
                general_cpu_reference,
                (None, elide, GENERAL_SYSTEMS, 64, t_full, {}, True, 0))
        for v in GENERAL_VARIANTS:
            jobs["b", v] = pool.submit(
                general_cpu_reference,
                (v, True, VARIANT_SYSTEMS, VARIANT_CPU, t_full, {}, False,
                 0))
        jobs["d"] = pool.submit(
            general_cpu_reference, ("severed", True, 8, 8, 32, {}, True, 200))
        res = _phase_general_card(card, jobs)
    finally:
        pool.shutdown(cancel_futures=True)
    return res


def _phase_general_card(card, jobs):
    from hpa2_tpu_torch import cli
    from hpa2_tpu_torch.convert import sim_state_to_numpy
    from hpa2_tpu_torch.ops.engine import BatchTorchEngine, StallDiagnostic
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    err = 0
    k2 = {}
    k2_launches = 0
    # (a) MESI/full/ideal at 4,096 systems, elision on and off
    heads = {}
    for elide in (True, False):
        label = f"headline elision {'on' if elide else 'off'}"
        cfg = general_config(elide=elide)
        arrays = gen_uniform_random_arrays(cfg, GENERAL_SYSTEMS,
                                           GENERAL_RUN_INSTRS, seed=0)
        got, rec = run_general(label, cfg, arrays, card)
        heads[elide] = (got, rec)
        e, k2_ms, n = k2_cross_check(label, cfg, arrays, got, block=512)
        err = max(err, e)
        k2_launches += n
        k2[label] = k2_ms
        # 64 of the systems through BatchTorchEngine on the card, and on
        # the CPU: every field; the 4,096-system run's first 64: every
        # field a batch does not change
        sub = [a[:64] for a in arrays]
        eng = BatchTorchEngine(cfg, arrays_to_traces(sub),
                               device="cuda").run()
        mine = sim_state_to_numpy(eng.state)
        want = jobs["a", elide].result()
        e1 = state_err(f"{label}, 64 systems: card against CPU", mine, want)
        # (and but tr_val: the engine's Instr lists carry no value for
        # a read, the bench arrays a random one the step never reads)
        e2 = state_err(
            f"{label}: the 4,096-system run's first 64 against the CPU",
            {f: v[:64] for f, v in got.items()}, want,
            [f for f in want
             if f not in BATCH_GLOBAL + ("tr_val", "seconds")])
        err = max(err, e1, e2)
        print(f"[compare] {label}: BatchTorchEngine on 64 systems, card "
              f"against CPU ({want['seconds']:.1f} s there): every field "
              f"equal, max_abs_err={e1}; the 4,096-system run's first 64 "
              f"against the CPU: every field but {BATCH_GLOBAL} (batch-"
              f"global) and tr_val equal, max_abs_err={e2}")
    on, off = heads[True][0], heads[False][0]
    e = state_err("elision on against off", on, off,
                  [f for f in on if f not in ("n_elided", "n_multi_hit")])
    print(f"[compare] headline: elision on against off: every field but "
          f"n_elided/n_multi_hit equal, max_abs_err={e}; "
          f"{int(on['n_elided'].max())} cycles elided")
    # the profiler's count of kernels in one eager gated step
    kernels_a_step = gated_step_kernels(general_config(), heads[True][1])

    # (b) the variants at 1,024 systems
    variants = {}
    for v in GENERAL_VARIANTS:
        cfg = general_config(v)
        arrays = gen_uniform_random_arrays(cfg, VARIANT_SYSTEMS,
                                           GENERAL_RUN_INSTRS, seed=0)
        got, rec = run_general(v, cfg, arrays, card)
        sub = [a[:VARIANT_CPU] for a in arrays]
        mine, _ = run_general(f"{v}, first {VARIANT_CPU}", cfg, sub, card)
        want = jobs["b", v].result()
        e1 = state_err(f"{v}: card against CPU", mine, want)
        e2 = state_err(f"{v}: the full run's first {VARIANT_CPU}",
                       {f: x[:VARIANT_CPU] for f, x in got.items()}, want,
                       [f for f in want
                        if f not in BATCH_GLOBAL + ("seconds",)])
        err = max(err, e1, e2)
        extra = {k: int(got[f].sum()) for k, f in (
            ("forwards", "n_forwards"), ("owner_transfers", "n_owner_xfer"),
            ("dir_overflows", "n_dir_overflow"),
            ("topo_delay_cycles", "n_topo_delay"),
            ("multicast_saved", "n_multicast_saved"),
            ("combined", "n_combined"), ("link_traversals",
                                         "link_traversals"),
            ("fault_retransmissions", "n_retrans"),
            ("fault_dups", "n_dup_filtered"),
            ("fault_reorders", "n_reorder_fixed"),
            ("fault_delays", "n_delays")) if int(got[f].sum())}
        print(f"[compare] {v}: {VARIANT_CPU} systems, card against CPU "
              f"({want['seconds']:.1f} s there): every field (link planes "
              f"and fault counters included) equal, max_abs_err={e1}; the "
              f"{VARIANT_SYSTEMS}-system run's first {VARIANT_CPU}: every "
              f"field but {BATCH_GLOBAL} equal, max_abs_err={e2}; {extra}")
        variants[v] = dict(ms=rec["ms"], cycles=rec["cycles"],
                           steps=rec["steps"], err=max(e1, e2))

    # (c) the 64-node configuration at 256 systems against K2
    cfg = general_config(num_procs=64, max_instr_num=0)
    arrays = gen_uniform_random_arrays(cfg, WIDE_GENERAL_SYSTEMS, 64, seed=0)
    got, wide = run_general("64 nodes", cfg, arrays, card)
    e, k2_ms, n = k2_cross_check("64 nodes", cfg, arrays, got, block=256)
    err = max(err, e)
    k2_launches += n
    k2["64 nodes"] = k2_ms

    # (d) a severed edge: the watchdog's diagnostic on the card and on
    # the CPU
    cfg = general_config("severed")
    arrays = gen_uniform_random_arrays(cfg, 8, 32, seed=0)
    try:
        BatchTorchEngine(cfg, arrays_to_traces(arrays), watchdog_cycles=200,
                         device="cuda").run()
        raise AssertionError("severed edge: no StallDiagnostic on the card")
    except StallDiagnostic as e:
        diag = e
    want = jobs["d"].result()
    if want.get("error") != "StallDiagnostic" or any(
            getattr(diag, f) != want[f] for f in DIAG_FIELDS):
        raise AssertionError(f"severed edge: the card's diagnostic differs "
                             f"from the CPU's: {want.get('error')}")
    print(f"[compare] severed edge 1->0 (drop 1.0), 8 systems, watchdog 200 "
          f"cycles: StallDiagnostic on the card at cycle {diag.cycle}, "
          f"every field equal to the CPU's ({diag.reason})")

    # the commands: run --backend jax on the card and the CPU, and bench
    work = ROOT / "hpa2_tpu_torch" / "build" / "smoke_general"
    shutil.rmtree(work, ignore_errors=True)
    traces = work / "traces"
    traces.mkdir(parents=True)
    rng = np.random.default_rng(11)
    for core in range(4):
        (traces / f"core_{core}.txt").write_text("".join(
            f"WR 0x{int(rng.integers(0, 64)):02X} {int(rng.integers(0, 256))}\n"
            if rng.random() < 0.5 else f"RD 0x{int(rng.integers(0, 64)):02X}\n"
            for _ in range(24)))
    flags = ["--robust", "--protocol", "moesi", "--topology", "mesh2d",
             "--multicast", "--fault-drop", "0.2", "--fault-seed", "3"]
    outs = {}
    for dev in ("cuda", "cpu"):
        with contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["run", str(traces), "--backend", "jax", "--out",
                           str(work / dev), "--device", dev] + flags)
        if rc != 0:
            raise AssertionError(f"run --backend jax --device {dev}: {rc}")
        outs[dev] = {p.name: p.read_bytes()
                     for p in sorted((work / dev).glob("core_*_output.txt"))}
    if len(outs["cuda"]) != 4 or outs["cuda"] != outs["cpu"]:
        raise AssertionError("run --backend jax: dumps differ between cuda "
                             "and cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", "--backend", "jax", "--batch",
                       str(VARIANT_SYSTEMS), "--instrs",
                       str(GENERAL_RUN_INSTRS),
                       "--nodes", "8", "--msg-buffer-size", "16", "--robust",
                       "--device", "cuda"])
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or rec["backend"] != "jax" or rec["device"] != "cuda" \
            or rec["instrs"] != VARIANT_SYSTEMS * 8 * GENERAL_RUN_INSTRS:
        raise AssertionError(f"bench --backend jax on the card: {rec}")
    print(f"[run] --backend jax {' '.join(flags)}: 4 dumps byte-identical "
          f"between the card and the CPU; [bench] --backend jax --batch "
          f"{VARIANT_SYSTEMS}: {rec['seconds']} s, {rec['ops_per_sec']} "
          "RD/WR ops/s")
    head = heads[True][1]
    return dict(err=err, k2=k2, k2_launches=k2_launches, head=head,
                head_off=heads[False][1], variants=variants, wide=wide,
                kernels_a_step=kernels_a_step)


def gated_step_kernels(cfg, head):
    """Kernels one gated step of the headline launches, counted by the
    profiler on an eager step (a chunk's graph holds ``chunk`` of
    them)."""
    from torch.profiler import ProfilerActivity, profile

    from hpa2_tpu_torch.ops.state import init_state_batched
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    arrays = gen_uniform_random_arrays(cfg, GENERAL_SYSTEMS,
                                       GENERAL_RUN_INSTRS, seed=0)
    st = init_state_batched(cfg, *arrays, device="cuda")
    run = head["run"]
    run.advance_chunk(st, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run.advance_chunk(st, 1)
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(e.device_time for e in evs)
    print(f"[general] one eager gated step of the headline (elision on): "
          f"{len(evs)} kernels, {us:.1f} us of device time (profiler); "
          f"the graph's ops a step: {run.launches_per_chunk // run.chunk}")
    return len(evs)


# ---------------------------------------------------------------------------
# [general scheduled], [serve jax], [recovery]: the general engine's
# scheduled runs, its serving backend and the recovery supervisor


#: part [general scheduled]: the scheduler's zipf workload at the
#: headline configuration (bench.py:197-260; lengths over [16, 128]),
#: streamed through 1,024 rows; 32 of the systems at 8 rows also run on
#: the CPU
SCHED_SYSTEMS, SCHED_RESIDENT, SCHED_INTERVAL = 4096, 1024, 256
SCHED_CPU, SCHED_CPU_RESIDENT = 32, 8
#: parts [serve jax] and [recovery]: bench.py:538-690's zipf feed
#: (spread 4, seed 0) at the headline configuration
SERVE_JAX_JOBS, RECOVERY_JOBS = 2048, 2048
SERVE_JAX = dict(backend="jax", resident=1024, interval=256,
                 max_trace_len=GENERAL_INSTRS, device="cuda")
RECOVERY_PALLAS = dict(backend="pallas", resident=1024, window=32, block=512,
                       device="cuda")
#: the fields a schedule leaves as they are: everything but the
#: batch-global ones (BATCH_GLOBAL) and the trace planes, which a
#: scheduled run pads to its own longest trace
SCHED_FIELDS_SKIP = BATCH_GLOBAL + ("seconds",)


def sched_arrays(cfg):
    from hpa2_tpu_torch.utils.trace import gen_heterogeneous_random_arrays

    return gen_heterogeneous_random_arrays(cfg, SCHED_SYSTEMS,
                                           GENERAL_INSTRS, dist="zipf",
                                           spread=8.0, seed=0)


def scheduled_cpu_reference(fused):
    """The first ``SCHED_CPU`` systems of the scheduled workload through
    ``BatchTorchEngine(schedule=Schedule(resident=8, ...))`` on the CPU,
    in a worker process: (state as numpy arrays, occupancy dict)."""
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    from hpa2_tpu_torch.convert import sim_state_to_numpy
    from hpa2_tpu_torch.ops.engine import BatchTorchEngine
    from hpa2_tpu_torch.ops.schedule import Schedule

    cfg = general_config()
    arrays = [a[:SCHED_CPU] for a in sched_arrays(cfg)]
    t0 = time.perf_counter()
    eng = BatchTorchEngine(
        cfg, arrays_to_traces(arrays), device="cpu",
        schedule=Schedule(resident=SCHED_CPU_RESIDENT,
                          interval=SCHED_INTERVAL, fused=fused)).run()
    out = sim_state_to_numpy(eng.state)
    out["seconds"] = time.perf_counter() - t0
    return out, eng.occupancy.as_dict()


def _host_state(st):
    from hpa2_tpu_torch.ops.state import SimState

    return SimState(*(x.cpu() for x in st))


def phase_general_scheduled(card):
    """``BatchTorchEngine(schedule=...)`` on the card at the headline
    configuration: 4,096 zipf-length systems unscheduled, then streamed
    through 1,024 rows fused, then by the host chunk loop at interval
    256.  Each scheduled run's dumps, snapshots, counters and
    ``stats()`` must equal the unscheduled run's; on 32 of the systems
    at 8 rows, fused and host loop, every field must equal the CPU's
    (worker processes, started first)."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    try:
        jobs = {fused: pool.submit(scheduled_cpu_reference, fused)
                for fused in (True, False)}
        return _phase_general_scheduled_card(card, jobs)
    finally:
        pool.shutdown(cancel_futures=True)


def _phase_general_scheduled_card(card, jobs):
    from hpa2_tpu_torch.convert import sim_state_to_numpy
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.engine import BatchTorchEngine, build_batched_run
    from hpa2_tpu_torch.ops.schedule import Schedule

    cfg = general_config()
    arrays = sched_arrays(cfg)
    traces = arrays_to_traces(arrays)
    instrs = int(arrays[3].sum())
    strip = ("elided_cycles", "multi_hit_retired")
    runs, states, err = {}, {}, 0
    for label, schedule in (
            ("unscheduled", None),
            ("fused", Schedule(resident=SCHED_RESIDENT)),
            ("host loop", Schedule(resident=SCHED_RESIDENT,
                                   interval=SCHED_INTERVAL, fused=False))):
        eng = BatchTorchEngine(cfg, traces, schedule=schedule,
                               device="cuda")
        # the unscheduled and fused runs' graphs are captured before the
        # clock starts; the host loop's is captured on its bound rows,
        # inside the run (its time printed apart)
        if schedule is None:
            build_batched_run(cfg).prepare(eng.state)
        elif schedule.fused:
            build_batched_run(cfg).prepare(
                eng._fresh(np.arange(SCHED_RESIDENT)))
        syncs = kernels.HOST_SYNCS.count
        _, ms = elapsed_ms(eng.run)
        syncs = kernels.HOST_SYNCS.count - syncs
        if int(eng.state.n_instr.sum()) != instrs:
            raise AssertionError(f"general scheduled {label}: "
                                 f"{int(eng.state.n_instr.sum())} RD/WR "
                                 f"retired of {instrs}")
        states[label] = sim_state_to_numpy(eng.state)
        stats = eng.stats()
        occ = eng.occupancy.as_dict() if eng.occupancy else None
        runs[label] = dict(ms=ms, syncs=syncs, stats=stats,
                           chunks=(occ or {}).get("intervals"))
        print(f"[general scheduled] {label}: {SCHED_SYSTEMS} systems x "
              f"{cfg.num_procs} nodes x <= {GENERAL_INSTRS} instrs (zipf, "
              f"spread 8): {ms:.3f} ms (CUDA events around run(), host "
              f"work included), {instrs / ms * 1e3:.4e} RD/WR ops/s, "
              f"{syncs} host syncs, chunks {runs[label]['chunks']}, "
              f"occupancy {occ} ({card})")
        if label == "unscheduled":
            continue
        e = state_err(f"general scheduled {label} against unscheduled",
                      states[label], states["unscheduled"],
                      [f for f in states[label]
                       if f not in SCHED_FIELDS_SKIP])
        want = {k: v for k, v in runs["unscheduled"]["stats"].items()
                if k not in strip}
        if {k: v for k, v in stats.items() if k not in strip} != want:
            raise AssertionError(f"general scheduled {label}: stats() "
                                 "differ from the unscheduled run's")
        err = max(err, e)
        print(f"[compare] general scheduled {label}: dumps, snapshots and "
              f"per-system counters of {SCHED_SYSTEMS} systems equal the "
              f"unscheduled run's, max_abs_err={e}; stats() equal but the "
              "batch-dependent elision counters")
    # 32 of the systems at 8 rows, fused and host loop: card against CPU
    sub = arrays_to_traces([a[:SCHED_CPU] for a in arrays])
    for fused in (True, False):
        eng = BatchTorchEngine(
            cfg, sub, device="cuda",
            schedule=Schedule(resident=SCHED_CPU_RESIDENT,
                              interval=SCHED_INTERVAL, fused=fused)).run()
        want, want_occ = jobs[fused].result()
        label = "fused" if fused else "host loop"
        e = state_err(f"general scheduled {label}, {SCHED_CPU} systems: "
                      "card against CPU", sim_state_to_numpy(eng.state),
                      want)
        if eng.occupancy.as_dict() != want_occ:
            raise AssertionError(f"general scheduled {label}: occupancy "
                                 "differs from the CPU's")
        err = max(err, e)
        print(f"[compare] general scheduled {label}, {SCHED_CPU} systems "
              f"through {SCHED_CPU_RESIDENT} rows: every field and the "
              f"occupancy equal the CPU's ({want['seconds']:.1f} s there), "
              f"max_abs_err={e}")
    return dict(err=err, runs=runs)


@contextlib.contextmanager
def timed_chunks(bound):
    """A pair of CUDA events around the graph replays of every chunk a
    bound chunk program (``ops/step.py:BoundChunk``) enqueues, read
    only afterwards, and the host seconds of each graph capture; yields
    (the list of (start, end) pairs, the list of capture seconds)."""
    advance, capture = bound.advance, bound._capture
    pairs, captures = [], []

    def timed_capture():
        t0 = time.perf_counter()
        capture()
        captures.append(time.perf_counter() - t0)

    def timed():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        advance()
        end.record()
        pairs.append((start, end))

    bound.advance, bound._capture = timed, timed_capture
    try:
        yield pairs, captures
    finally:
        del bound.advance, bound._capture


def served_map(results, cycles=True):
    keys = ("instructions", "cycles", "messages") if cycles else (
        "instructions", "messages")
    return {r.job_id: (r.dumps, {k: r.counters[k] for k in keys})
            for r in results}


def check_served(label, results, want, cycles=True):
    got = served_map(results, cycles)
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: jobs served {len(got)} of "
                             f"{len(want)}, or some twice")
    for jid, (dumps, counters) in got.items():
        wd, wc = want[jid]
        if dumps != wd or any(counters[k] != wc[k] for k in counters):
            raise AssertionError(f"{label}: {jid}'s dumps or counters "
                                 "differ from the reference's")


def stats_line(tag, label, st, card, extra=""):
    d = st.as_dict()
    occ, lat = d["occupancy"], d["latency_s"]
    print(f"[{tag}] {label}: {d['jobs_completed']} jobs, "
          f"{occ.get('intervals')} intervals, {occ.get('admissions')} "
          f"admissions; {d['instructions']} RD/WR in {st.wall_s:.6f} s "
          f"wall: {st.ops_per_s:.1f} RD/WR ops/s; host_staging_s "
          f"{st.host_staging_s:.6f}, device_wait_s {st.device_wait_s:.6f}, "
          f"readback_s {st.readback_s:.6f}; latency p50 {lat['p50']} s, p99 "
          f"{lat['p99']} s; compile counts {d['compile_counts']}{extra} "
          f"({card})")


def phase_serve_jax(card):
    """``serve(backend="jax")`` on the card: 2,048 zipf jobs through
    1,024 rows at interval 256, overlap on and off, every job's dumps
    and counters equal to the one-shot host-loop run's (``cycles`` too
    for the serial run, whose admissions land at the one-shot run's
    barriers; the pipelined run admits a chunk later), zero recompiles;
    then ``jax_window=32`` against ``serve(backend="pallas")`` at
    window 32, block 512, in one pass whose every K2 launch is held
    against the plain version."""
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.engine import BatchTorchEngine
    from hpa2_tpu_torch.ops.schedule import Schedule
    from hpa2_tpu_torch.serving import (
        ListJobSource, build_serving, serve, synthetic_jobs,
    )

    cfg = general_config()
    jobs = synthetic_jobs(cfg, SERVE_JAX_JOBS, GENERAL_INSTRS, seed=0,
                          dist="zipf", spread=4.0)
    t0 = time.perf_counter()
    ref = BatchTorchEngine(
        cfg, [j.batch_traces() for j in jobs], device="cuda",
        schedule=Schedule(resident=SERVE_JAX["resident"],
                          interval=SERVE_JAX["interval"], fused=False)).run()
    ref_s = time.perf_counter() - t0
    ref.state = _host_state(ref.state)
    want = {j.job_id: (ref.system_final_dumps(s), {
        "instructions": int(ref.state.n_instr[s]),
        "cycles": int(ref.state.cycle[s]),
        "messages": int(ref.state.n_msgs[s])}) for s, j in enumerate(jobs)}
    print(f"[serve jax] one-shot reference (BatchTorchEngine, "
          f"Schedule(resident={SERVE_JAX['resident']}, interval="
          f"{SERVE_JAX['interval']}, fused=False)): {ref_s:.3f} s")
    out = {}
    for overlap in (True, False):
        drv = build_serving(cfg, ListJobSource(jobs), overlap=overlap,
                            **SERVE_JAX)
        ptrs = [x.data_ptr() for x in drv.session.state]
        syncs = kernels.HOST_SYNCS.count
        with timed_chunks(drv.session._bound) as (pairs, captures):
            results, st = drv.run()
        syncs = kernels.HOST_SYNCS.count - syncs
        busy_ms = launches_ms(pairs)
        label = "pipelined" if overlap else "serial"
        check_served(f"serve jax {label}", results, want,
                     cycles=not overlap)
        if set(st.compile_counts.values()) != {1}:
            raise AssertionError(f"serve jax {label}: compile counts "
                                 f"{st.compile_counts}")
        if [x.data_ptr() for x in drv.session.state] != ptrs:
            raise AssertionError(f"serve jax {label}: the rows moved")
        cap = sum(captures)
        stats_line("serve jax", label, st, card,
                   f"; {syncs} host syncs; the chunks' replays "
                   f"{busy_ms:.3f} ms on the card (device idle "
                   f"{1 - busy_ms / 1e3 / st.wall_s:.4f} of the wall); the "
                   f"chunk graph's capture {cap:.3f} s inside the wall")
        out[label] = dict(wall_s=st.wall_s, syncs=syncs, busy_ms=busy_ms,
                          ops_per_s=st.ops_per_s)
    print(f"[compare] serve jax: {SERVE_JAX_JOBS} jobs, pipelined and "
          "serial: every job's dumps and counters equal the one-shot "
          "run's (cycles: the serial run), compile counts all 1, the "
          "resident rows kept their storage")

    # the window emulation against the fast path, every K2 launch checked
    wkw = dict(SERVE_JAX, jax_window=RECOVERY_PALLAS["window"])
    jres, jst = serve(cfg, ListJobSource(jobs), **wkw)
    stats_line("serve jax", f"jax_window={wkw['jax_window']}", jst, card)
    for kern in kernels.KERNELS:
        kern.launches = 0
    with checked_kernels("serve jax cross-check") as chk:
        pres, pst = serve(cfg, ListJobSource(jobs), **RECOVERY_PALLAS)
    launches = kernels.STREAM_RUN.launches
    if launches == 0 or chk["stream_run"] != launches:
        raise AssertionError(f"serve jax cross-check: {launches} K2 "
                             f"launches, {chk['stream_run']} checked")
    check_served("serve jax window against pallas", jres,
                 served_map(pres, cycles=False), cycles=False)
    print(f"[compare] serve jax cross-check: jax_window="
          f"{wkw['jax_window']} against serve(backend='pallas', resident="
          f"{RECOVERY_PALLAS['resident']}, window="
          f"{RECOVERY_PALLAS['window']}, block={RECOVERY_PALLAS['block']}): "
          f"every job's dumps, instructions and messages equal; "
          f"{launches} K2 launches each held against the plain version, "
          f"max_abs_err={chk['err']} ({chk['idle_lanes']} idle lanes, "
          f"{chk['ragged_lanes']} with a window ending early)")
    return dict(runs=out, launches=launches, checked=chk["stream_run"],
                err=chk["err"], window_wall_s=jst.wall_s)


def phase_recovery(card):
    """The recovery supervisor on the card, the fast path primary at
    1,024 lanes, window 32, block 512, on 2,048 of the zipf jobs:
    ``kill@3``, ``hang@3`` and ``poison@3:1`` must each end
    byte-identical to the unfailed run (the primary's K2 launches
    counted from 0 in the kill run); a jax -> jax ``kill@4`` must resume
    rows mid-state from a schema-v2 checkpoint; a checkpoint of rows on
    the card must load back equal in every field; ``bench --backend jax
    --checkpoint-every`` must finish, clear its directory and resume a
    mid checkpoint to the straight run's counts; and the ``serve``
    commands with ``--backend jax`` and with ``--failure-plan
    kill@3 --checkpoint-dir`` (run in processes of their own while this
    one works) must write the reference's dump files."""
    from hpa2_tpu_torch.serving import job_to_record, synthetic_jobs

    cfg = general_config()
    jobs = synthetic_jobs(cfg, SERVE_JAX_JOBS, GENERAL_INSTRS, seed=0,
                          dist="zipf", spread=4.0)[:RECOVERY_JOBS]
    work = ROOT / "hpa2_tpu_torch" / "build" / "smoke_recovery"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    # the serve commands on 64 of the jobs run in processes of their
    # own while this one works; their dumps are checked at the end
    feed = work / "jobs.jsonl"
    feed.write_text("".join(json.dumps(job_to_record(j)) + "\n"
                            for j in jobs[:64]))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    common = ["--nodes", "8", "--msg-buffer-size", "16", "--robust",
              "--resident", "64", "--max-instr", str(GENERAL_INSTRS),
              "--immediate", "--device", "cuda"]
    commands = {}
    try:
        for name, flags in (
                ("jax", ["--backend", "jax", "--interval", "256"]),
                ("kill", ["--failure-plan", "kill@3", "--checkpoint-dir",
                          str(work / "cli_ck"), "--window", "32",
                          "--block", "64"])):
            logs = [open(work / f"cli_{name}.{x}", "w+")
                    for x in ("out", "err")]
            commands[name] = (flags, logs, subprocess.Popen(
                [sys.executable, "-m", "hpa2_tpu_torch", "serve", str(feed)]
                + common + flags + ["--out", str(work / f"cli_{name}")],
                stdout=logs[0], stderr=logs[1], text=True, env=env,
                cwd=str(work)))
        return _phase_recovery(card, cfg, jobs, work, commands)
    finally:
        for _, logs, proc in commands.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            for f in logs:
                f.close()


def _phase_recovery(card, cfg, jobs, work, commands):
    import tempfile

    from hpa2_tpu_torch import cli
    from hpa2_tpu_torch.config import FailurePlan
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.engine import BatchLaneSession
    from hpa2_tpu_torch.ops.state import init_state_batched
    from hpa2_tpu_torch.ops.step import build_batched_run_chunk
    from hpa2_tpu_torch.serving import ListJobSource, serve, supervised_serve
    from hpa2_tpu_torch.utils.checkpoint import load_state, save_state
    from hpa2_tpu_torch.utils.dump import format_processor_state
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    base, bst = serve(cfg, ListJobSource(jobs), **RECOVERY_PALLAS)
    want = served_map(base, cycles=False)
    stats_line("recovery", "unfailed fast path", bst, card)
    res = {}
    for plan in ("kill@3", "hang@3", "poison@3:1"):
        ckdir = tempfile.mkdtemp(dir=work)
        launches = kernels.STREAM_RUN.launches
        got, st = supervised_serve(cfg, ListJobSource(jobs),
                                   plan=FailurePlan.parse(plan),
                                   checkpoint_dir=ckdir, **RECOVERY_PALLAS)
        launches = kernels.STREAM_RUN.launches - launches
        check_served(f"recovery {plan}", got, want, cycles=False)
        rec = {k: v for k, v in st.occupancy["recovery"].items()
               if k != "events"}
        if rec["failures_detected"] != 1 or launches == 0 \
                or st.jobs_completed != RECOVERY_JOBS:
            raise AssertionError(f"recovery {plan}: {rec}, {launches} K2 "
                                 "launches")
        stats_line("recovery", plan, st, card,
                   f"; recovery {rec}; K2 launches {launches}; wall "
                   f"{st.wall_s / bst.wall_s:.2f}x the unfailed run's")
        res[plan] = dict(launches=launches, wall_s=st.wall_s, rec=rec)
    # the primary's path: kill@3 again, its launch counts from 0 and
    # every K2 launch held against the plain version
    for kern in kernels.KERNELS:
        kern.launches = 0
    with checked_kernels("recovery primary") as chk:
        got, st = supervised_serve(
            cfg, ListJobSource(jobs), plan=FailurePlan.parse("kill@3"),
            checkpoint_dir=tempfile.mkdtemp(dir=work), **RECOVERY_PALLAS)
    launches = kernels.STREAM_RUN.launches
    check_served("recovery kill@3, checked", got, want, cycles=False)
    if launches == 0 or chk["stream_run"] != launches:
        raise AssertionError(f"recovery primary: {launches} K2 launches, "
                             f"{chk['stream_run']} checked")
    print(f"[compare] recovery: kill@3, hang@3 and poison@3:1 on "
          f"{RECOVERY_JOBS} jobs: every job's dumps, instructions and "
          "messages byte-identical to the unfailed run's; kill@3 again "
          f"with each of the primary's {launches} K2 launches held against "
          f"the plain version: max_abs_err={chk['err']}")

    # jax -> jax: rows resume mid-state from the schema-v2 npz
    jbase, jbst = serve(cfg, ListJobSource(jobs), **SERVE_JAX)
    jwant = served_map(jbase, cycles=False)
    ckdir = tempfile.mkdtemp(dir=work)
    got, st = supervised_serve(
        cfg, ListJobSource(jobs), plan=FailurePlan.parse("kill@4"),
        targets=[{"backend": "jax", "data_shards": 1}],
        checkpoint_dir=ckdir, **SERVE_JAX)
    check_served("recovery jax -> jax kill@4", got, jwant, cycles=False)
    rec = {k: v for k, v in st.occupancy["recovery"].items()
           if k != "events"}
    npz = sorted(p.name for p in pathlib.Path(ckdir).glob("*.npz"))
    if rec["lanes_resumed"] < 1 or not npz:
        raise AssertionError(f"recovery jax -> jax: {rec}, {npz}")
    stats_line("recovery", "jax -> jax kill@4", st, card,
               f"; recovery {rec}; checkpoints {npz}; wall "
               f"{st.wall_s / jbst.wall_s:.2f}x the unfailed jax run's")

    # a checkpoint of rows on the card loads back equal in every field
    sess = BatchLaneSession(cfg, SERVE_JAX["resident"], GENERAL_INSTRS,
                            interval=SERVE_JAX["interval"], device="cuda")
    for i, j in enumerate(jobs[:SERVE_JAX["resident"]]):
        sess.admit(i, sess.fresh_row(j.batch_traces()))
    sess.advance()
    sess.quiescent_rows()
    path = str(work / "rows.npz")
    save_state(path, sess.state, cfg, extra_meta={"rows": "card"})
    back, back_cfg, meta = load_state(path, with_meta=True, device="cuda")
    bad = [f for f, a, b in zip(back._fields, back, sess.state)
           if a.dtype != b.dtype or not torch.equal(a, b)]
    if bad or back_cfg != cfg or meta["rows"] != "card":
        raise AssertionError(f"checkpoint round trip on the card: {bad}")
    print(f"[compare] checkpoint: {SERVE_JAX['resident']} rows on the card "
          f"after one chunk, saved ({os.path.getsize(path)} B) and loaded "
          "back: every field equal")

    # bench --backend jax --checkpoint-every: straight, then resumed
    ck = work / "bench_ck"
    bench = ["bench", "--backend", "jax", "--batch", "1024", "--instrs",
             str(GENERAL_INSTRS), "--nodes", "8", "--msg-buffer-size", "16",
             "--robust", "--checkpoint-every", "128", "--checkpoint-dir",
             str(ck), "--device", "cuda"]
    recs = []
    for resume in (False, True):
        if resume:
            # the command's own config: general_config() is the one
            # these flags build
            st = init_state_batched(cfg, *gen_uniform_random_arrays(
                cfg, 1024, GENERAL_INSTRS, seed=0), device="cuda")
            run_chunk = build_batched_run_chunk(cfg, 128)
            mid = run_chunk(run_chunk(st))
            save_state(str(ck / "ckpt_2.npz"), mid, cfg, extra_meta={
                "batch": 1024, "instrs": GENERAL_INSTRS,
                "workload": "uniform", "seed": 0})
        buf, err_buf = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(err_buf):
            rc = cli.main(bench)
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        left = sorted(p.name for p in ck.glob("ckpt_*.npz"))
        if rc != 0 or left or rec["device"] != "cuda" \
                or ("resumed from" in err_buf.getvalue()) != resume:
            raise AssertionError(f"bench --checkpoint-every: rc {rc}, "
                                 f"{rec}, left {left}")
        recs.append(rec)
    straight, resumed = recs
    if straight["instrs"] != 1024 * 8 * GENERAL_INSTRS \
            or resumed["resumed_instrs"] != int(mid.n_instr.sum()) \
            or resumed["instrs"] + resumed["resumed_instrs"] \
            != straight["instrs"]:
        raise AssertionError(f"bench resume: {straight}, {resumed}")
    print(f"[bench] --backend jax --batch 1024 --checkpoint-every 128: "
          f"{straight['seconds']} s, {straight['ops_per_sec']} RD/WR ops/s "
          f"(checkpoint writes included), directory cleared; resumed from a "
          f"mid checkpoint: {resumed['resumed_instrs']} RD/WR already "
          f"retired + {resumed['instrs']} = the straight run's "
          f"{straight['instrs']}")

    # the serve commands on 64 of the jobs, started with the phase
    for name, ref in (("jax", jwant), ("kill", want)):
        flags, logs, proc = commands[name]
        out = work / f"cli_{name}"
        proc.wait(timeout=600)
        for f in logs:
            f.seek(0)
        stdout, stderr = (f.read() for f in logs)
        if proc.returncode != 0:
            raise AssertionError(f"serve command ({name}) exited "
                                 f"{proc.returncode}:\n{stderr[-3000:]}")
        stats = json.loads(stdout.strip().splitlines()[-1])
        if name == "kill" and stats["occupancy"].get("recovery", {}).get(
                "failures_detected") != 1:
            raise AssertionError(f"serve command ({name}): the kill did not "
                                 f"fire: {stats['occupancy']}")
        files = 0
        for j in jobs[:64]:
            for d in ref[j.job_id][0]:
                f = out / j.job_id / f"core_{d.proc_id}_output.txt"
                if f.read_text() != format_processor_state(d, cfg):
                    raise AssertionError(f"serve command ({name}): {f} "
                                         "differs from the reference")
                files += 1
        print(f"[recovery] python -m hpa2_tpu_torch serve {' '.join(flags)}"
              f" ({len(jobs[:64])} jobs): {files} dump files equal the "
              "reference's; "
              f"jobs_completed {stats['jobs_completed']}, recovery "
              f"{ {k: v for k, v in stats['occupancy'].get('recovery', {}).items() if k != 'events'} }")
    return dict(runs=res, launches=launches, checked=chk["stream_run"],
                err=chk["err"])


RUN_WORK = ROOT / "hpa2_tpu_torch" / "build" / "smoke_run"


def write_run_traces():
    """A fresh work directory with a 4-node trace directory of 24
    uniform-random instructions a core (seed 7); returns both."""
    shutil.rmtree(RUN_WORK, ignore_errors=True)
    traces = RUN_WORK / "traces"
    traces.mkdir(parents=True)
    rng = np.random.default_rng(7)
    for core in range(4):
        lines = []
        for _ in range(24):
            a = int(rng.integers(0, 64))
            lines.append(f"WR 0x{a:02X} {int(rng.integers(0, 256))}"
                         if rng.random() < 0.5 else f"RD 0x{a:02X}")
        (traces / f"core_{core}.txt").write_text("\n".join(lines) + "\n")
    return RUN_WORK, traces


def phase_run_command():
    """``python -m hpa2_tpu_torch run`` on a synthesized trace
    directory, on the card and on the CPU (the dumps must be equal),
    and ``bench`` on the card (every instruction must retire)."""
    from hpa2_tpu_torch import cli
    from hpa2_tpu_torch.ops import kernels

    work, traces = write_run_traces()
    outs = {}
    for kern in kernels.KERNELS:
        kern.launches = 0
    for dev in ("cuda", "cpu"):
        out = work / dev
        rc = cli.main(["run", str(traces), "--backend", "pallas",
                       "--robust", "--out", str(out), "--device", dev])
        if rc != 0:
            raise AssertionError(f"run --device {dev} exited {rc}")
        outs[dev] = {p.name: p.read_bytes()
                     for p in sorted(out.glob("core_*_output.txt"))}
    if sum(kern.launches for kern in kernels.KERNELS) == 0:
        raise AssertionError("the run command never launched the kernel")
    if len(outs["cuda"]) != 4 or outs["cuda"] != outs["cpu"]:
        raise AssertionError("run dumps differ between cuda and cpu")
    print(f"[run] 4-node trace directory: {len(outs['cuda'])} dumps "
          "byte-identical between the card and the CPU plain run")

    # the bench command (warm-up run + timed run), its JSON line kept
    # off stdout's own JSON lines
    before = kernels.STREAM_RUN.launches
    batch, instrs = 4096, 128
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", "--backend", "pallas", "--batch",
                       str(batch), "--instrs", str(instrs), "--nodes", "8",
                       "--msg-buffer-size", "16", "--robust", "--seed", "0"])
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or rec["backend"] != "pallas" or rec["device"] != "cuda" \
            or rec["instrs"] != batch * 8 * instrs \
            or kernels.STREAM_RUN.launches != before + 2:
        raise AssertionError(f"bench on the card: rc {rc}, {rec}")
    print(f"[bench] {batch} systems x 8 nodes x {instrs} instrs (block "
          f"1024, one window, snapshots off): {rec['seconds']} s, "
          f"{rec['ops_per_sec']} RD/WR ops/s")

    # the scheduled bench: zipf lengths through 1,024 resident lanes
    before = kernels.STREAM_RUN.launches
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", "--backend", "pallas", "--batch",
                       str(batch), "--instrs", str(instrs), "--nodes", "8",
                       "--msg-buffer-size", "16", "--robust", "--seed", "0",
                       "--block", "512",
                       "--trace-window", "32", "--trace-len-dist", "zipf",
                       "--schedule-resident", "1024"])
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    occ = rec.get("occupancy") or {}
    if rc != 0 or rec["workload"] != "zipf" \
            or occ.get("admissions") != batch - 1024 \
            or kernels.STREAM_RUN.launches == before:
        raise AssertionError(f"scheduled bench on the card: rc {rc}, {rec}")
    print(f"[bench] --trace-len-dist zipf --schedule-resident 1024, {batch} "
          f"systems: {rec['seconds']} s, {rec['ops_per_sec']} RD/WR ops/s, "
          f"occupancy {occ}")


# ---------------------------------------------------------------------------
# [entry]: the entry points of the port (the bench harness, the CLI's
# workloads, backends and HEAD quirks, the model and serving studies)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def kept_launches():
    """Keep every K2 launch made inside: its arguments, a copy of the
    planes it was given (an asynchronous device copy, no host sync, so
    a timed run inside is not held up) and the planes it updated in
    place.  :func:`check_kept` holds them against the plain version
    afterwards.  Yields the list of launches."""
    from hpa2_tpu_torch.ops import kernels

    launch = kernels.stream_run
    kept = []

    def stream_run(config, state, tr, tr_len, **kw):
        if not tr.is_cuda:  # the CPU's plain version, not a launch
            return launch(config, state, tr, tr_len, **kw)
        before = {f: v.clone() for f, v in state.items()}
        status = launch(config, state, tr, tr_len, **kw)
        kept.append(dict(config=config, before=before, after=state,
                         status=status, tr=tr, tr_len=tr_len, kw=dict(kw)))
        return status

    kernels.stream_run = stream_run
    try:
        yield kept
    finally:
        kernels.stream_run = launch


def _same_inputs(a, b):
    return (a["config"] == b["config"] and a["kw"] == b["kw"]
            and a["tr"].shape == b["tr"].shape
            and bool(torch.equal(a["tr"], b["tr"]))
            and bool(torch.equal(a["tr_len"], b["tr_len"]))
            and set(a["before"]) == set(b["before"])
            and all(bool(torch.equal(a["before"][f], b["before"][f]))
                    for f in a["before"]))


def check_kept(label, kept, checked=None):
    """Hold every kept launch against the plain version: the first
    launch of each set of identical inputs (configuration, arguments,
    traces and planes) runs ``stream_run_plain`` on its copy, and every
    launch of the set must give those planes and that stall plane bit
    for bit (a harness's warm-up and timed runs share one plain run).
    ``checked`` (the planes of a launch already held against the plain
    version on the same inputs) stands in for the plain run: the planes
    must be digest-equal to it, and the run must not have stalled.  A
    plain run on at most ``HOST_CHECK_LANES`` lanes goes to the host
    pool, with host copies of the planes each launch left.  Returns a
    function that waits for those and returns (launches, plain runs,
    max abs difference, plain ms)."""
    from hpa2_tpu_torch.ops.stream_run import stream_run_plain

    refs, plain_ms = [], 0.0
    for rec in kept:
        ref = next((r for r in refs if _same_inputs(r[0], rec)), None)
        if ref is None and checked is not None:
            ref = [rec, checked, torch.zeros_like(rec["status"])]
        if ref is None:
            if rec["tr_len"].shape[-1] <= HOST_CHECK_LANES:
                ref = [rec, submit_plain("stream", rec["config"],
                                         rec["before"], rec["tr"],
                                         rec["tr_len"], rec["kw"]), None]
            else:
                before = {f: v.clone() for f, v in rec["before"].items()}
                (want, want_status), ms = elapsed_ms(
                    lambda: stream_run_plain(rec["config"], before,
                                             rec["tr"], rec["tr_len"],
                                             **rec["kw"]))
                plain_ms += ms
                ref = [rec, want, want_status]
            refs.append(ref)
        rec["ref"] = ref
        if ref[2] is None:  # compared on the host, after the plain run
            rec["after"] = {f: host_copy(v)
                            for f, v in rec["after"].items()}
            rec["status"] = host_copy(rec["status"])

    def finish():
        nonlocal plain_ms
        for ref in refs:
            if ref[2] is None:
                want, status, secs = ref[1].result()
                plain_ms += secs * 1e3
                ref[1:] = [{f: torch.from_numpy(v) for f, v in want.items()},
                           torch.from_numpy(status)]
        err = 0
        for rec in kept:
            ref = rec.pop("ref")
            diff = plane_diff(rec["config"], rec["kw"]["snapshots"],
                              rec["after"], ref[1],
                              rec["kw"].get("packed", False))
            diff["stall"] = int((rec["status"].long()
                                 - ref[2].long()).abs().max())
            err = max(err, check_diff(label, diff))
        return len(kept), len(refs), err, plain_ms
    return finish


def _zero_launches():
    from hpa2_tpu_torch.ops import kernels

    for kern in kernels.KERNELS:
        kern.launches = 0


def _k2_launches(label):
    """K2's launches since :func:`_zero_launches`; the streamed path
    must have run it and the per-call kernel not at all."""
    from hpa2_tpu_torch.ops import kernels

    n = kernels.STREAM_RUN.launches
    if n == 0 or kernels.CALL_RUN.launches:
        raise AssertionError(
            f"{label}: K2 launched {n} times, K3 "
            f"{kernels.CALL_RUN.launches} times")
    return n


def _entry_path(paths, name, launches, kept, checked=None, **extra):
    """Record an entry point's path in ``paths`` and start holding its
    kept launches against the plain version; :func:`_settle_entry`
    finishes the check."""
    if len(kept) != launches:
        raise AssertionError(
            f"entry {name}: {len(kept)} launches kept of {launches}")
    paths[name] = dict(launches=launches, **extra)
    ENTRY_CHECKS.append((name, check_kept(f"entry {name}", kept, checked)))
    return paths[name]


def _settle_entry(paths):
    """Finish the checks :func:`_entry_path` started, in their order."""
    while ENTRY_CHECKS:
        name, finish = ENTRY_CHECKS.pop(0)
        n, plain_runs, err, plain_ms = finish()
        paths[name].update(checked_launches=n, plain_runs=plain_runs,
                           max_abs_err=err, plain_ms=plain_ms)
        how = (f"{plain_runs} plain runs, {plain_ms:.1f} ms" if plain_runs
               else "digest-equal to [headline]'s checked launch on the "
               "same arrays")
        print(f"[entry] {name}: {paths[name]['launches']} K2 launches, each "
              f"held against the plain version ({how}): max_abs_err={err}")


#: the entry points' checks still running (:func:`_settle_entry`)
ENTRY_CHECKS = []


def _quiet(fn, *args):
    """``fn(*args)`` with its stdout kept; -> (result, the lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().strip().splitlines()


def _dump_dicts(dumps):
    return [d.__dict__ for d in dumps]


def phase_entry(card, headline=None):
    """The port's entry points on the card, each K2 launch held against
    the plain version (``kept_launches``):

    1. the bench harness's headline (``hpa2_tpu_torch.bench``, in
       process) at 32,768 x 8 x 128, its warm-up and timed launches on
       one set of inputs (``headline``: the planes of ``[headline]``'s
       checked launch on the same arrays, if that phase ran), with the
       OpenMP baseline's rate required;
    2. ``bench --backend pallas --workload producer-consumer`` and
       ``local`` at 1,024 x 8 x 64, eight of each ensemble's systems
       with dumps equal to the spec engine on the host;
    3. the fast path under the HEAD value quirks (``eager-write``,
       ``flush-old-fill``, both) at 1,024 x 8 x 64 uniform, NACK
       policy on so that random traffic completes; both quirks under
       fixture semantics, whose drop
       policy livelocks random traffic, to a stall at a 512-cycle
       budget; ``run --quirks`` on the 4-node trace directory
       byte-identical on the card, the CPU, ``spec`` and ``omp``;
    4. ``run --backend spec`` and ``omp`` equal to ``pallas`` on the
       card, and a ``--crash-at`` / ``--resume`` pair equal to the
       straight run;
    5. ``--topology`` at the JAX bench's sizes and ``--protocol`` on 2
       systems a row where they have 4 (``spec_jax_agree_all``),
       ``--serve`` and ``--failover`` at 2,048 jobs through 1,024
       lanes.
    Returns the per-path records for K2's ``by_path``."""
    import dataclasses

    from hpa2_tpu_torch import bench, cli
    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.models.spec_engine import SpecEngine, StallError
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
    from hpa2_tpu_torch.ops.layout import decode_dumps
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    paths = {}

    # 1. the headline of the bench harness
    _zero_launches()
    with kept_launches() as kept:
        rec = bench.headline_main("cuda")
    n = _k2_launches("entry bench headline")
    if (rec["platform"] != "gpu" or not rec["indicative"]
            or rec["jax_instrs"] != 32768 * 8 * 128
            or not rec.get("omp_ops_per_sec") or rec["vs_baseline"] is None
            or not rec["device"]["power_limit"]):
        raise AssertionError(f"bench headline: {rec}")
    _entry_path(paths, "bench headline", n, kept, checked=headline,
                engine_ms=rec["jax_seconds"] * 1e3,
                ops_per_sec=rec["value"], vs_baseline=rec["vs_baseline"])
    print("[entry] bench headline line: " + json.dumps(rec))

    # 2. the CLI's workloads
    robust = Semantics().robust()
    cfg = SystemConfig(semantics=robust, **HEADLINE)
    batch, instrs = 1024, 64
    for wl in ("producer-consumer", "local"):
        _zero_launches()
        t0 = time.perf_counter()
        with kept_launches() as kept:
            rc, lines = _quiet(cli.main, [
                "bench", "--backend", "pallas", "--workload", wl,
                "--batch", str(batch), "--instrs", str(instrs), "--nodes",
                "8", "--msg-buffer-size", "16", "--robust", "--seed", "0"])
        wall = time.perf_counter() - t0
        n = _k2_launches(f"entry bench {wl}")
        wrec = json.loads(lines[-1])
        if (rc != 0 or wrec["backend"] != "pallas"
                or wrec["workload"] != wl or wrec["device"] != "cuda"
                or wrec["instrs"] != batch * 8 * instrs):
            raise AssertionError(f"bench --workload {wl}: rc {rc}, {wrec}")
        path = _entry_path(paths, f"bench {wl}", n, kept,
                           engine_ms=wrec["seconds"] * 1e3)
        final = kept[-1]["after"]
        cachew = final["cachew"].cpu().numpy()
        dirw = final["dirw"].cpu().numpy()
        gen = cli._generator(wl)
        picked = [int(b) for b in np.linspace(0, batch - 1, 8)]
        for b in picked:
            spec = SpecEngine(cfg, gen(cfg, instrs, seed=b))
            spec.run()
            if _dump_dicts(decode_dumps(cfg, cachew, dirw, b)) \
                    != _dump_dicts(spec.final_dumps()):
                raise AssertionError(
                    f"bench --workload {wl}: system {b}'s dumps differ "
                    "from the spec engine's")
        path["spec_systems"] = picked
        print(f"[entry] bench --workload {wl}: {batch} x 8 x {instrs}, "
              f"{wrec['seconds']} s timed, {wrec['ops_per_sec']} RD/WR "
              f"ops/s ({wall:.1f} s with the Python trace build); systems "
              f"{picked} equal to the spec engine's final dumps")

    # 3. the HEAD value quirks on K2
    quirks = {
        "eager-write": dict(eager_write_request_memory=True),
        "flush-old-fill": dict(flush_invack_fills_old_value=True),
        "eager-write,flush-old-fill": dict(
            eager_write_request_memory=True,
            flush_invack_fills_old_value=True),
    }
    arrays = gen_uniform_random_arrays(cfg, batch, instrs, seed=0)

    def quirk_run(qcfg, max_cycles=1_000_000):
        eng = CudaEngine(qcfg, *arrays, block=512, cycles_per_call=128,
                         snapshots=False, trace_window=32, gate=True)
        _, ms = elapsed_ms(lambda: eng.run(max_cycles))
        return eng, ms

    for name, flags in quirks.items():
        qcfg = dataclasses.replace(
            cfg, semantics=dataclasses.replace(robust, **flags))
        _zero_launches()
        with kept_launches() as kept:
            eng, ms = quirk_run(qcfg)
        n = _k2_launches(f"entry quirks {name}")
        if eng.instructions != batch * 8 * instrs:
            raise AssertionError(f"quirks {name}: {eng.instructions} "
                                 "instructions retired")
        _entry_path(paths, f"quirks {name}", n, kept, engine_ms=ms)
        print(f"[entry] quirks {name} (NACK policy): {batch} x 8 x "
              f"{instrs}, every instruction retired, in {ms:.3f} ms")
    fixture = dataclasses.replace(
        cfg, semantics=Semantics(**quirks["eager-write,flush-old-fill"]))
    _zero_launches()
    with kept_launches() as kept:
        try:
            quirk_run(fixture, max_cycles=512)
            raise AssertionError("fixture semantics on random traffic "
                                 "did not stall")
        except StallError as e:
            stall = str(e).splitlines()[0]
    n = _k2_launches("entry quirks fixture stall")
    _entry_path(paths, "quirks fixture stall", n, kept, stall=stall)

    work, traces = write_run_traces()

    def run_cmd(tag, *flags):
        out = work / tag
        rc, _ = _quiet(cli.main, ["run", str(traces), "--robust", "--out",
                                  str(out), *flags])
        if rc != 0:
            raise AssertionError(f"run {tag} exited {rc}")
        got = {p.name: p.read_bytes()
               for p in sorted(out.glob("core_*_output.txt"))}
        if len(got) != 4:
            raise AssertionError(f"run {tag}: {len(got)} dumps")
        return got

    _zero_launches()
    with kept_launches() as kept:
        runs = {}
        for q in ("", "eager-write,flush-old-fill"):
            qf = ["--quirks", q] if q else []
            for be, dev in (("pallas", "cuda"), ("pallas", "cpu"),
                            ("spec", None), ("omp", None)):
                tag = f"{be}-{dev or 'host'}-{q or 'none'}"
                runs[tag] = run_cmd(
                    tag, "--backend", be, *qf,
                    *(["--device", dev] if dev else []))
            want = runs[f"spec-host-{q or 'none'}"]
            bad = [t for t, r in runs.items()
                   if t.endswith(q or "none") and r != want]
            if bad:
                raise AssertionError(f"run --quirks {q!r}: {bad} differ "
                                     "from spec")
        if runs["spec-host-none"] == runs[
                "spec-host-eager-write,flush-old-fill"]:
            raise AssertionError("run: the quirks changed no dump")
    n = _k2_launches("entry run")
    _entry_path(paths, "run commands", n, kept)
    ckpt = work / "spec_ckpt.json"
    rc, _ = _quiet(cli.main, ["run", str(traces), "--backend", "spec",
                              "--robust", "--crash-at", "20",
                              "--crash-checkpoint", str(ckpt)])
    resumed = run_cmd("resumed", "--backend", "spec", "--resume", str(ckpt))
    if rc != 0 or resumed != runs["spec-host-none"]:
        raise AssertionError("run --crash-at 20 / --resume: dumps differ "
                             "from the straight run")
    print("[entry] run on the 4-node trace directory: pallas on the card "
          "and the CPU, spec and omp byte-identical with and without "
          "--quirks eager-write,flush-old-fill (the quirks change the "
          "dumps); spec --crash-at 20 then --resume equal to the straight "
          "run")

    # 5. the model and serving studies (--protocol on 2 systems a row
    # where the harness has 4: a cut for time)
    for name, fn, env in (("topology", bench.topo_main, {}),
                          ("protocol", bench.protocol_main,
                           {"HPA2_PROTO_BATCH": "2"})):
        t0 = time.perf_counter()
        os.environ.update(env)
        try:
            srec = fn("cuda")
        finally:
            for k in env:
                del os.environ[k]
        if not srec["spec_jax_agree_all"] or srec["platform"] != "gpu":
            raise AssertionError(f"bench --{name}: {srec}")
        print(f"[entry] bench --{name}: {srec['metric']} {srec['value']} "
              f"{srec['unit']}, spec_jax_agree_all true, "
              f"{time.perf_counter() - t0:.1f} s")
    os.environ["HPA2_SERVE_JOBS"] = "2048"
    os.environ["HPA2_SERVE_RESIDENT"] = "1024"
    try:
        for name, fn in (("serve", bench.serve_main),
                         ("failover", bench.failover_main)):
            _zero_launches()
            t0 = time.perf_counter()
            srec = fn("cuda")
            n = _k2_launches(f"entry bench --{name}")
            if name == "failover" and not all(
                    r["byte_identical"] for r in srec["runs"].values()):
                raise AssertionError(f"bench --failover: {srec['runs']}")
            paths[f"bench {name}"] = dict(launches=n, value=srec["value"],
                                          unit=srec["unit"])
            print(f"[entry] bench --{name} (2,048 jobs, 1,024 lanes): "
                  f"{srec['metric']} {srec['value']} {srec['unit']}, {n} "
                  f"K2 launches, {time.perf_counter() - t0:.1f} s: "
                  + json.dumps(srec))
    finally:
        del os.environ["HPA2_SERVE_JOBS"], os.environ["HPA2_SERVE_RESIDENT"]
    _settle_entry(paths)
    return paths


def micro_ops(name, planes, out, iters, block):
    """Integer operations pattern ``name`` does on ``planes`` (its
    inputs on the card) to give ``out``: the JAX body's elementwise ops
    per (row, lane), not its one-hot expansion, counted for what these
    inputs need (the candidates that are valid and accepted, the sums
    that are even, the blocks whose gate stays open)."""
    from hpa2_tpu_torch.scripts import micro_kernels as mk

    n, lanes = planes["rows"].shape
    if name == "empty":
        return 0
    if name == "scalar_gate":
        # 2N adds a lane an iteration; a block whose sum is 0 leaves its
        # loop after the first
        sums = torch.stack([planes["rows"], planes["cnt"]]).long().reshape(
            2 * n, -1, block).sum((0, 2))
        live = int((sums != 0).sum())
        return (live * iters + (sums.numel() - live)) * block * 2 * n
    if name == "rowops300":
        # a step: &, ==, +, select, *, +, &
        return lanes * n * iters * 100 * 7
    if name == "deliver40":
        # a candidate: recv (+, &) and valid (>>, &, ==); a valid one:
        # pos (+) and the < CAP test; an accepted one: w (*, +) and
        # acc += 1; per node an iteration: cnt + acc
        rows = planes["rows"]
        valid = sum(int(((rows[(j + 1) % n] >> (j & 3)) & 1).sum())
                    for j in range(mk.J))
        accepted = int(out["cnt"].long().sum() - planes["cnt"].long().sum())
        return iters * (lanes * mk.J * 5 + valid * 2 + lanes * n) \
            + accepted * 3
    # rw_9x: six reads (+, &, out +=), the parity test (&, ==), the
    # final & 127; per even sum three write indices (+, &).  rows after
    # an iteration is out & 127, so it has out's parity.
    even, st = 0, planes
    for _ in range(iters):
        st = mk.plain(name, st, iters=1, block=block)
        even += int(((st["rows"] & 1) == 0).sum())
    return lanes * n * iters * 21 + even * 6


def phase_micro():
    """K4, the op-pattern micro-kernels.  The path is the runner:
    ``main()`` (every pattern at grid 32) and ``bench`` at grid 128,
    with the launch counts zeroed just before and read just after.
    Then each pattern's kernel at both sizes, on fresh planes, is held
    bit for bit against its plain version on the card, and the
    runner's checksum against the plain version's; the bound is the
    larger of the bytes (each plane read and written once) over 3.35
    TB/s and the integer operations over ``SCALAR_OPS_PER_S``."""
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.scripts import micro_kernels as mk

    arrays = {grid: mk.make_arrays(mk.B * grid) for grid in MICRO_GRIDS}
    kernels.MICRO.launches = 0
    for name in mk.LAUNCHES:
        mk.LAUNCHES[name] = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        recs = {MICRO_GRIDS[0]: mk.main("cuda")}
        recs[MICRO_GRIDS[1]] = [
            mk.bench(name, arrays[MICRO_GRIDS[1]], MICRO_GRIDS[1],
                     device="cuda") for name in mk.PATTERNS]
    launches = dict(mk.LAUNCHES)
    total = kernels.MICRO.launches
    if min(launches.values()) == 0 or total != sum(launches.values()):
        raise AssertionError(f"micro-kernels: launches {launches}, {total}")
    for line in buf.getvalue().splitlines():
        print(f"[micro] {line}")

    res, err = {}, 0
    for grid, grid_recs in recs.items():
        for rec in grid_recs:
            name = rec["name"]
            label = f"micro {name} grid {grid}"
            planes = {k: torch.from_numpy(arrays[grid][k]).cuda()
                      for k in mk.PATTERNS[name]}
            got = {k: v.clone() for k, v in planes.items()}
            mk.micro_run(name, got, iters=mk.K, block=mk.B)
            want, plain_ms = elapsed_ms(lambda: mk.plain(
                name, planes, iters=mk.K, block=mk.B))
            e = check_diff(label, {
                k: int((got[k].long() - want[k].long()).abs().max())
                for k in want})
            err = max(err, e)
            first = mk.PATTERNS[name][0]
            if rec["checksum"] != mk.checksum(want[first]):
                raise AssertionError(
                    f"{label}: the runner's checksum {rec['checksum']} is "
                    f"not the plain version's {mk.checksum(want[first])}")
            moved = 2 * sum(v.numel() * v.element_size()
                            for v in planes.values())
            ops = micro_ops(name, planes, want, mk.K, mk.B)
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / SCALAR_OPS_PER_S * 1e3
            ms = rec["total_s"] * 1e3
            row = dict(ms=ms, plain_ms=plain_ms,
                       bound_ms=max(bytes_ms, ops_ms),
                       bound_by="bytes" if bytes_ms >= ops_ms
                       else "operations", bytes=moved, ops=ops,
                       us_per_iter_per_block=rec["us_per_iter_per_block"],
                       checksum=rec["checksum"])
            if "accepted" in rec:
                row["accepted"] = rec["accepted"]
            res[name, grid] = row
            print(f"[micro] {name} grid {grid} ({mk.B * grid} lanes, K "
                  f"{mk.K}): kernel {ms:.6f} ms (median of 3; "
                  f"{rec['us_per_iter_per_block']:.6f} us per iteration "
                  f"per block), plain {plain_ms:.3f} ms, max_abs_err={e}; "
                  f"bound {row['bound_ms']:.6f} ms by {row['bound_by']} "
                  f"({moved} B / 3.35 TB/s = {bytes_ms:.6f} ms; {ops} int "
                  f"ops / {SCALAR_OPS_PER_S:.4e} ops/s = {ops_ms:.6f} ms)"
                  + (f"; {rec['accepted']} deliveries accepted"
                     if "accepted" in rec else ""))
    return dict(launches=launches, total=total, err=err, res=res)


def micro_entry(kern, micro):
    """The micro-kernels' line: the runner's launches, and at the
    script's grid the five patterns' summed kernel and plain times
    against the bound of the five patterns' work together; per pattern
    and size in ``patterns``."""
    grid = MICRO_GRIDS[0]
    rows = {name: r for (name, g), r in micro["res"].items() if g == grid}
    bytes_ms = sum(r["bytes"] for r in rows.values()) / HBM_BYTES_PER_S * 1e3
    ops_ms = sum(r["ops"] for r in rows.values()) / SCALAR_OPS_PER_S * 1e3
    keys = ("ms", "plain_ms", "bound_ms", "bound_by",
            "us_per_iter_per_block", "accepted")
    return {
        "name": kern.name, "route": "cuda", "source": kern.source,
        "replaces": kern.replaces, "launches": micro["total"],
        "max_abs_err": micro["err"],
        "ms": sum(r["ms"] for r in rows.values()),
        "plain_ms": sum(r["plain_ms"] for r in rows.values()),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "patterns": {
            name: {"launches": n, **{
                f"grid {g}": {k: micro["res"][name, g][k] for k in keys
                              if k in micro["res"][name, g]}
                for g in MICRO_GRIDS}}
            for name, n in micro["launches"].items()},
    }


#: the ``[ablate]`` cases: (kernel, node bound, stage set, num_procs,
#: systems, instructions a core, lane block, packed); every ablation
#: instantiation (K2 and K3 at node bounds 8, 21 and 64, int32 and packed
#: planes) at least once, every stage alone and the three together at
#: least once for each layout.  The small lane blocks
#: fit one CTA; those of 512 give the clusters that
#: ``scripts/perf_sweep.py``'s attribution times (``launch_geometry``: 2
#: CTAs at 8 nodes, 8 at 21, 16 at 64), so the ablated cross-CTA code
#: (the gate's cluster ORs, delivery and ``inv_acc`` across CTAs, the
#: stubbed walks and clears) is held against the plain version at every
#: stage set that the attribution times with K2, and at ``phase_a``
#: (delivery kept) and ``deliver`` with K3.
ABL_ALL = ("phase_a", "phase_b", "deliver")
ABLATE_CASES = (
    ("stream", 8, ("phase_a",), 8, 64, 16, 32, False),
    ("stream", 21, ("phase_b",), 12, 32, 12, 16, False),
    ("stream", 64, ("deliver",), 64, 16, 8, 16, False),
    ("call", 8, ABL_ALL, 8, 64, 16, 32, False),
    ("call", 21, ("deliver",), 12, 32, 12, 16, False),
    ("call", 64, ABL_ALL, 64, 16, 8, 16, False),
) + tuple(
    ("stream", bound, names, n, 1024, t, 512, False)
    for bound, n, t in ((8, 8, 16), (64, 64, 8))
    for names in (("phase_a",), ("phase_b",), ("deliver",), ABL_ALL)
) + tuple(
    ("call", bound, names, n, b, t, 512, False)
    for bound, n, b, t in ((8, 8, 1024, 16), (64, 64, 1024, 8))
    for names in (("phase_a",), ("deliver",))
) + (
    ("stream", 21, ("phase_a",), 12, 512, 12, 512, False),
    ("call", 21, ("phase_a",), 12, 512, 12, 512, False),
) + (
    # the packed instantiations (u8/u16 planes): every bound and kernel in
    # a lane block of one CTA and in the attribution's clusters, every
    # stage set among each kernel's; at 64 nodes only the sets whose
    # traffic stops (a kept phase A or B makes the 64-node plain version
    # run ~3.5 s a case)
    ("stream", 8, ("phase_b",), 8, 64, 16, 32, True),
    ("stream", 21, ("phase_a",), 12, 32, 12, 16, True),
    ("stream", 64, ABL_ALL, 64, 16, 8, 16, True),
    ("call", 8, ("phase_a",), 8, 64, 16, 32, True),
    ("call", 21, ("phase_b",), 12, 32, 12, 16, True),
    ("call", 64, ("deliver",), 64, 16, 8, 16, True),
    ("stream", 8, ("phase_a",), 8, 1024, 16, 512, True),
    ("stream", 21, ("phase_b",), 12, 512, 12, 512, True),
    ("stream", 64, ("deliver",), 64, 1024, 8, 512, True),
    ("call", 8, ("deliver",), 8, 1024, 16, 512, True),
    ("call", 21, ABL_ALL, 12, 512, 12, 512, True),
    ("call", 64, ABL_ALL, 64, 1024, 8, 512, True),
)
#: the ablated runs' budget: four calls of 8 cycles
ABLATE_K, ABLATE_CYCLES = 8, 32


def plane_bytes(planes) -> int:
    return sum(v.numel() * v.element_size() for v in planes.values())


def phase_ablate():
    """``[ablate]``: K1's ablation variant inside K2 and K3
    (``kernels.ABLATE_KERNELS``), driven through ``CudaEngine(_ablate=)``
    as ``scripts/perf_sweep.py --ablate`` drives it, at a small depth
    (:data:`ABLATE_CASES`, a budget of 32 cycles, which every ablated run
    reaches with a ``StallError``).  Every launch is held plane for plane
    (and, streamed, stall plane) against the plain ablated version on a
    copy of its planes, and timed by CUDA events around the library
    launch; the plain version is timed alone.  The ablation libraries'
    counts are zeroed before the runs and read after; the default
    libraries must not launch.  Returns the kernels line's records."""
    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.call_run import call_plain
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
    from hpa2_tpu_torch.ops.layout import StallError
    from hpa2_tpu_torch.ops.stream_run import stream_run_plain
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    robust = Semantics().robust()
    libs = {"stream": kernels.STREAM_RUN_ABLATE,
            "call": kernels.CALL_RUN_ABLATE}
    rec = {kern.name: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "err": 0,
                       "checked": 0, "cases": []} for kern in libs.values()}
    wrapped = {"stream_run": kernels.stream_run,
               "call_run": kernels.call_run}
    pending = []

    def timed(kern):
        launch = kern.launch

        def run(*args, device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(*args, device=device)
            end.record()
            pending.append((kern.name, start, end))
        return run

    def settle():
        torch.cuda.synchronize()
        for name, a, b in pending:
            rec[name]["ms"] += a.elapsed_time(b)
        pending.clear()

    def check(name, config, kw, before, got, want, status=None):
        diff = plane_diff(config, kw["snapshots"], got, want, kw["packed"])
        if status is not None:
            diff["status"] = int((status[0].long()
                                  - status[1].long()).abs().max())
        r = rec[name]
        r["err"] = max(r["err"], check_diff(f"ablate {name}", diff))
        r["checked"] += 1
        # bytes: every carried plane read and written, the traces read
        r["bytes"] += 2 * plane_bytes(before) + kw["tr_bytes"]

    def stream_run(config, state, tr, tr_len, **kw):
        before = {f: v.clone() for f, v in state.items()}
        status = wrapped["stream_run"](config, state, tr, tr_len, **kw)
        settle()
        (want, want_status), plain = elapsed_ms(
            lambda: stream_run_plain(config, before, tr, tr_len, **kw))
        rec["stream_run_ablate"]["plain_ms"] += plain
        check("stream_run_ablate", config,
              dict(kw, tr_bytes=plane_bytes({"tr": tr, "l": tr_len})),
              before, state, want, (status, want_status))
        return status

    def call_run(config, state, tr, tr_len, *, seg, **kw):
        before = {f: v.clone() for f, v in state.items()}
        wrapped["call_run"](config, state, tr, tr_len, seg=seg, **kw)
        settle()
        want, plain = elapsed_ms(lambda: call_plain(
            config, before, tr, tr_len, seg=seg, **kw))
        rec["call_run_ablate"]["plain_ms"] += plain
        check("call_run_ablate", config,
              dict(kw, tr_bytes=plane_bytes({"tr": tr, "l": tr_len})),
              before, state, want)

    for kern in kernels.LIBRARIES:
        kern.launches = 0
    for kern in libs.values():
        kern.launch = timed(kern)
    kernels.stream_run, kernels.call_run = stream_run, call_run
    try:
        for what, bound, names, n, b, t, block, packed in ABLATE_CASES:
            cfg = SystemConfig(num_procs=n, msg_buffer_size=16,
                               semantics=robust)
            assert kernels.node_bound(cfg) == bound
            arrays = gen_uniform_random_arrays(cfg, b, t, seed=bound)
            eng = CudaEngine(cfg, *arrays, block=block,
                             cycles_per_call=ABLATE_K, snapshots=False,
                             trace_window=t // 2, stream=what == "stream",
                             packed=packed, _ablate=frozenset(names))
            t0 = time.perf_counter()
            try:
                eng.run(max_cycles=ABLATE_CYCLES)
            except StallError:
                pass
            else:
                raise AssertionError(f"ablated {names} run quiesced")
            cycles = int(eng.state["scalars"][0].max())
            if cycles != ABLATE_CYCLES:
                raise AssertionError(
                    f"ablated {names} ran {cycles} cycles, not "
                    f"{ABLATE_CYCLES}")
            lib = libs[what]
            layout = "packed" if packed else "int32"
            rec[lib.name]["cases"].append(
                f"{'+'.join(names)} at bound {bound}, {layout}")
            print(f"[ablate] {lib.name} node bound {bound} ({n} nodes), "
                  f"{layout} planes, "
                  f"{'+'.join(names)}: {b} systems x {t} instrs, block "
                  f"{block}, k {ABLATE_K}, windows of {t // 2}: stalled at "
                  f"{cycles} cycles as it must, {lib.launches} launches so "
                  f"far, each held against the plain version, max_abs_err="
                  f"{rec[lib.name]['err']} "
                  f"({time.perf_counter() - t0:.1f} s)")
    finally:
        kernels.stream_run = wrapped["stream_run"]
        kernels.call_run = wrapped["call_run"]
        for kern in libs.values():
            del kern.launch
    launches = {kern.name: kern.launches for kern in kernels.LIBRARIES}
    for kern in libs.values():
        if launches[kern.name] == 0 or \
                rec[kern.name]["checked"] != launches[kern.name]:
            raise AssertionError(
                f"[ablate] {kern.name}: {launches[kern.name]} launches, "
                f"{rec[kern.name]['checked']} checked")
    if any(launches[kern.name] for kern in kernels.KERNELS):
        raise AssertionError(
            f"[ablate] an ablated run launched a default kernel: {launches}")
    out = []
    for what, kern in libs.items():
        r = rec[kern.name]
        bound_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        print(f"[ablate] {kern.name}: {launches[kern.name]} launches, "
              f"{r['ms']:.3f} ms on the card, plain {r['plain_ms']:.1f} ms, "
              f"bound {bound_ms:.6f} ms (bytes), max_abs_err={r['err']}")
        out.append({
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces,
            "variants": ["ablation stubs phase_a, phase_b, deliver (a "
                         "runtime mask); int32 and packed u8/u16 planes at "
                         "node bounds 8, 21 and 64; a deliberately wrong "
                         "cycle, timing only"],
            "launches": launches[kern.name], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None,
            "by_path": {"ablate": {"cases": r["cases"],
                                   "checked_launches": r["checked"]}},
        })
    return out


#: ``[scale]``: BASELINE.json's configuration 5 (1,024 systems x 8 nodes
#: x 10,000 instructions, ``scripts/scale_runs.py``) at full size, this
#: many of its systems (a fixed spread of indices) held against the spec
#: engine; configuration 4 (256 nodes) at full width and this depth (the
#: full run has 4,096 instructions a core)
SCALE5_CHECKED = 16
SCALE5_WINDOW = 32
SCALE4_INSTRS = 128
#: the general engine's per-system fields a single-system ``TorchEngine``
#: holds otherwise than the batch loop on ``init_state_batched``: its
#: key is ``PRNGKey(seed)`` where the batch's row 0 has ``fold_in(key,
#: 0)``, and its Instr lists carry no value for a read
SCALE4_SKIP = ("rng_key", "tr_val")


def scale5_spec_reference(job):
    """One worker's share of ``[scale]``'s config5 check: the port's spec
    engine on the fast path's window schedule (each window of
    ``window`` instructions a core run to quiescence, as ``CudaEngine``
    runs it) for each system's arrays; per system its final dumps,
    instructions and messages."""
    sys.path.insert(0, str(ROOT))
    from hpa2_tpu_torch.models.spec_engine import SpecEngine
    from hpa2_tpu_torch.scripts.scale_runs import config5_config

    arrays, window = job
    config = config5_config()
    out = []
    for traces in arrays_to_traces(arrays):
        t = max(len(tr) for tr in traces)
        spec = SpecEngine(config, [tr[:window] for tr in traces])
        spec.run()
        for s in range(window, t, window):
            spec.continue_with([tr[s:s + window] for tr in traces])
            spec.run()
        out.append(([d.__dict__ for d in spec.final_dumps()],
                    spec.instructions, spec.messages))
    return out


def scale4_cpu_reference(instrs):
    """``[scale]``'s config4 reference: ``TorchEngine(device="cpu")`` on
    config4's traces at ``instrs`` a core; its state as numpy arrays."""
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    from hpa2_tpu_torch.convert import sim_state_to_numpy
    from hpa2_tpu_torch.ops.engine import TorchEngine
    from hpa2_tpu_torch.scripts.scale_runs import config4_config
    from hpa2_tpu_torch.utils.trace import gen_producer_consumer_arrays

    config = config4_config()
    arrays = gen_producer_consumer_arrays(config, 1, instrs)
    t0 = time.perf_counter()
    eng = TorchEngine(config, arrays_to_traces(arrays)[0], device="cpu")
    eng.run()
    out = sim_state_to_numpy(eng.state)
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_scale(card):
    """``[scale]``: BASELINE.json's scaled configurations through
    ``hpa2_tpu_torch.scripts.scale_runs``.  Configuration 5 at full size
    (1,024 x 8 x 10,000, K2 in trace windows of 32, a warm run then a
    timed one), :data:`SCALE5_CHECKED` of its systems held against the
    spec engine on the same window schedule (final dumps, instructions
    and messages, tolerance zero; the spec engine runs in worker
    processes while the card works).  The native lockstep engine cannot
    be that oracle: it has no window schedule, and a system's
    interleaving, so its dumps, depends on the windows.  Configuration 4
    at full width (256 nodes, the general engine) and
    :data:`SCALE4_INSTRS` instructions a core, held field by field
    against ``TorchEngine(device="cpu")`` on the same traces.  K2's
    launch count is zeroed before configuration 5 and read after.
    Returns K2's ``by_path`` record."""
    import concurrent.futures
    import multiprocessing

    from hpa2_tpu_torch.convert import sim_state_to_numpy
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.layout import _SC_CYCLE, _SC_INSTR, _SC_MSGS
    from hpa2_tpu_torch.scripts import scale_runs

    # the CPU references start first: config4's, and the spec engine on
    # config5's checked systems (the arrays drawn here, as config5 draws
    # them), while the card runs config5
    t0 = time.perf_counter()
    arrays = scale_runs.config5_arrays()
    batch = arrays[0].shape[0]
    idx = np.linspace(0, batch - 1, SCALE5_CHECKED).astype(int)
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=5, mp_context=multiprocessing.get_context("spawn"))
    try:
        ref4 = pool.submit(scale4_cpu_reference, SCALE4_INSTRS)
        jobs = [pool.submit(scale5_spec_reference, (
            [a[part] for a in arrays], SCALE5_WINDOW))
            for part in np.array_split(idx, 4)]
        for kern in kernels.LIBRARIES:
            kern.launches = 0
        rec5, eng, _ = scale_runs.config5_run(arrays=arrays)
        wall5 = time.perf_counter() - t0
        launches = kernels.STREAM_RUN.launches
        if launches == 0 or any(k.launches for k in kernels.LIBRARIES
                                if k is not kernels.STREAM_RUN):
            raise AssertionError(
                f"[scale] config5: launches "
                f"{ {k.name: k.launches for k in kernels.LIBRARIES} }")
        if eng._window != SCALE5_WINDOW:
            raise AssertionError(f"[scale] config5 ran windows of "
                                 f"{eng._window}")
        sc = eng.state["scalars"].cpu().numpy()
        want = [r for job in jobs for r in job.result()]
        err = 0
        for b, (dumps, instrs, msgs) in zip(idx, want):
            if [d.__dict__ for d in eng.system_final_dumps(int(b))] != dumps:
                raise AssertionError(
                    f"[scale] config5 system {b}: dumps differ from the "
                    "spec engine's")
            err = max(err, abs(int(sc[_SC_INSTR, b]) - instrs),
                      abs(int(sc[_SC_MSGS, b]) - msgs))
        if err:
            raise AssertionError(f"[scale] config5: counts differ by {err}")
        # the bound: every carried plane read and written, the traces and
        # their lengths read once; the operations config5's own counters
        # say it needed
        moved = 2 * sum(v.numel() * v.element_size()
                        for v in eng.state.values()) + (
            eng._tr_full.numel() + eng._tr_len_full.numel()) * 4
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops = cycle_ops(rec5["nodes"], int(sc[_SC_CYCLE].sum()),
                        int(sc[_SC_MSGS].sum()), rec5["instructions"])
        ops_ms = ops / SCALAR_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"[scale] config5: {rec5['batch']} systems x {rec5['nodes']} "
              f"nodes x {rec5['instrs_per_core']} instrs, block "
              f"{rec5['block']}, windows of {eng._window}: "
              f"{rec5['instructions']} RD/WR in {rec5['cycles']} cycles, "
              f"{rec5['seconds'] * 1e3:.3f} ms by CUDA events "
              f"({rec5['us_per_cycle']} us a cycle, {rec5['ops_per_sec']:.4e}"
              f" RD/WR ops/s), {launches} K2 launches (warm and timed); "
              f"systems {idx.tolist()} equal to the spec engine on the same "
              f"windows (dumps, instructions, messages), max_abs_err={err}; "
              f"bound: bytes {moved} B / 3.35 TB/s = {bytes_ms:.4f} ms, "
              f"operations {ops} = {ops_ms:.4f} ms, run / bound "
              f"{rec5['seconds'] * 1e3 / bound_ms:.0f}; "
              f"{wall5:.1f} s with the trace generation, {card}")

        t0 = time.perf_counter()
        rec4, out4, _ = scale_runs.config4_run(SCALE4_INSTRS)
        got = sim_state_to_numpy(out4)
        want4 = ref4.result()
        err4 = state_err("[scale] config4 against TorchEngine on the CPU",
                         got, want4,
                         [f for f in want4
                          if f not in SCALE4_SKIP + ("seconds",)])
        print(f"[scale] config4: {rec4['nodes']} nodes ({rec4['sharer_words']}"
              f" sharer words) x {SCALE4_INSTRS} producer-consumer instrs a "
              f"core (the full run: 4,096): {rec4['instructions']} RD/WR in "
              f"{rec4['cycles']} cycles ({rec4['steps']} steps), "
              f"{rec4['seconds'] * 1e3:.3f} ms by CUDA events, "
              f"{rec4['us_per_cycle'] / 1e3:.4f} ms a cycle, "
              f"{rec4['host_syncs']} host syncs; every field but "
              f"{SCALE4_SKIP} equal to TorchEngine(device='cpu') "
              f"({want4['seconds']:.1f} s there), max_abs_err={err4} "
              f"({time.perf_counter() - t0:.1f} s)")
    finally:
        pool.shutdown(cancel_futures=True)
    return {"launches": launches, "ms": rec5["seconds"] * 1e3,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "us_per_cycle": rec5["us_per_cycle"],
            "ops_per_sec": rec5["ops_per_sec"], "cycles": rec5["cycles"],
            "checked_systems": idx.tolist(), "max_abs_err": max(err, err4),
            "held_to": "the spec engine on the same windows",
            "config4": {k: rec4[k] for k in (
                "nodes", "instrs_per_core", "instructions", "cycles",
                "seconds", "us_per_cycle")}}


#: ``[shard]``'s checked pass and fused scheduled run
SHARD_CHECKED = (1024, 32)
SHARD_ZIPF = (4096, 2048)
#: ``[shard]``'s node axis: (nodes, instructions a core) of each run
SHARD_NODE = ((8, 16), (16, 8))


def _node_jobs(cfg_of, node_shards, device):
    """NodeShardedEngine runs of ``SHARD_NODE`` in the a2a and pairwise
    schedules over ``node_shards`` ranks (one spawn), each against
    ``TorchEngine`` on the card: (engines, references)."""
    import dataclasses

    from hpa2_tpu_torch.ops.engine import TorchEngine
    from hpa2_tpu_torch.parallel import NodeShardedEngine, make_mesh
    from hpa2_tpu_torch.parallel.sharding import run_node_sharded
    from hpa2_tpu_torch.utils.trace import gen_uniform_random

    engs, refs = [], []
    for n, t in SHARD_NODE:
        cfg = cfg_of(n)
        traces = gen_uniform_random(cfg, t, seed=n)
        ref = TorchEngine(cfg, traces, device=device).run()
        for mode in (("a2a", "pairwise") if node_shards > 1 else ("a2a",)):
            engs.append(NodeShardedEngine(
                dataclasses.replace(cfg, exchange_mode=mode), traces,
                mesh=make_mesh(node_shards=node_shards, data_shards=1,
                               device=device)))
            refs.append(ref)
    run_node_sharded(engs)
    return engs, refs


def phase_shard(headline_state=None):
    """``[shard]``: the multi-GPU slice (``hpa2_tpu_torch.parallel``).

    The data axis over every card (two shards on ``cuda:0`` when there
    is one card): the headline ensemble through
    ``DataShardedCudaEngine`` equal plane for plane to one
    ``CudaEngine``'s run (``headline_state``, the checked headline
    planes) with one status read; a checked pass at 1,024 x 8 x 32
    whose every K2 and K3 launch is held against the plain version; a
    fused scheduled zipf run of 4,096 systems through 2,048 lanes equal
    to the unsharded one.  The node axis of the general engine over
    NCCL with ``min(4, cards)`` ranks (and 2 when there are four):
    ``NodeShardedEngine`` at 8 and 16 nodes in the a2a and pairwise
    schedules, each equal to ``TorchEngine`` on the card, and a cycle's
    collectives equal to ``plan_collectives`` plus one SUM and one MAX.
    With one card, a one-rank NCCL run through ``parallel/launch.py``.
    Returns the ``by_path`` records of K2 and K3."""
    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.ops import exchange, kernels
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
    from hpa2_tpu_torch.ops.schedule import Schedule
    from hpa2_tpu_torch.parallel import DataShardedCudaEngine, make_data_mesh
    from hpa2_tpu_torch.utils.trace import (
        gen_heterogeneous_random_arrays, gen_uniform_random_arrays,
    )

    cards = torch.cuda.device_count()
    mesh = (make_data_mesh() if cards > 1
            else make_data_mesh(2, devices=["cuda:0", "cuda:0"]))
    shards = len(mesh.devices)
    where = ", ".join(str(d) for d in mesh.devices)
    cfg = SystemConfig(semantics=Semantics().robust(), **HEADLINE)
    run = dict(block=HEADLINE_RUN["block"], cycles_per_call=HEADLINE_RUN["k"],
               snapshots=False, trace_window=HEADLINE_RUN["window"],
               gate=HEADLINE_RUN["gate"])
    k2, k3 = {}, {}

    # the headline ensemble over the data mesh
    arrays = gen_uniform_random_arrays(cfg, 32768, 128, seed=0)
    if headline_state is None:
        ref = CudaEngine(cfg, *arrays, **run)
        ref.run()
        headline_state = ref.state
    DataShardedCudaEngine(cfg, *arrays, mesh=mesh, **run).run()  # warm-up
    eng = DataShardedCudaEngine(cfg, *arrays, mesh=mesh, **run)
    for d in mesh.devices:
        torch.cuda.synchronize(d)
    _zero_launches()
    syncs = kernels.HOST_SYNCS.count
    t0 = time.perf_counter()
    eng.run()
    wall = (time.perf_counter() - t0) * 1e3
    syncs = kernels.HOST_SYNCS.count - syncs
    launches = _k2_launches("shard headline")
    got = eng.state
    err = check_diff("shard headline", plane_diff(
        cfg, False, {f: v.cuda() for f, v in got.items()}, headline_state))
    if launches != shards or syncs != 1:
        raise AssertionError(f"shard headline: {launches} K2 launches, "
                             f"{syncs} host syncs over {shards} shards")
    k2["shard headline"] = dict(
        launches=launches, host_syncs=syncs, max_abs_err=err,
        wall_ms=round(wall, 3), devices=where,
        held_to="the checked headline run's planes (one card)")
    print(f"[shard] data: 32768 x 8 x 128 over {shards} shards ({where}): "
          f"{launches} K2 launches (one a shard), {syncs} host sync, "
          f"{eng.instructions} RD/WR retired, run {wall:.3f} ms wall; "
          f"planes equal to one CudaEngine's: max_abs_err={err}")

    # a checked pass: every K2 and K3 launch against the plain version
    b, t = SHARD_CHECKED
    arrays = gen_uniform_random_arrays(cfg, b, t, seed=1)
    for stream, rec in ((True, k2), (False, k3)):
        name = "stream_run" if stream else "call_run"
        ref = CudaEngine(cfg, *arrays, stream=stream, **run)
        ref.run()
        _zero_launches()
        with checked_kernels(f"shard checked {name}") as chk:
            eng = DataShardedCudaEngine(cfg, *arrays, mesh=mesh,
                                        stream=stream, **run)
            eng.run()
        n = getattr(kernels, name.upper()).launches
        if n == 0 or chk[name] != n:
            raise AssertionError(f"shard checked {name}: {chk}, {n}")
        err = max(chk["err"], check_diff(
            f"shard checked {name}", plane_diff(
                cfg, False, {f: v.cuda() for f, v in eng.state.items()},
                ref.state)))
        rec["shard checked"] = dict(launches=n, checked_launches=chk[name],
                                    max_abs_err=err)
        print(f"[shard] data checked: {b} x 8 x {t} over {shards} shards, "
              f"{'streamed (K2)' if stream else 'per call (K3)'}: {n} "
              f"launches, each held against the plain version "
              f"(plain {chk['seconds']:.1f} s): max_abs_err={chk['err']}; "
              "planes equal to one card's run")

    # a fused scheduled zipf run
    b, resident = SHARD_ZIPF
    arrays = gen_heterogeneous_random_arrays(cfg, b, 128, dist="zipf",
                                             spread=8.0, seed=0)
    kw = dict(run, schedule=Schedule(resident=resident))
    ref = CudaEngine(cfg, *arrays, **kw)
    ref.run()
    _zero_launches()
    eng = DataShardedCudaEngine(cfg, *arrays, mesh=mesh, **kw)
    syncs = kernels.HOST_SYNCS.count
    eng.run()
    syncs = kernels.HOST_SYNCS.count - syncs
    launches = _k2_launches("shard fused zipf")
    err = check_diff("shard fused zipf", plane_diff(
        cfg, False, {f: v.cuda() for f, v in eng.state.items()}, ref.state))
    k2["shard fused zipf"] = dict(
        launches=launches, host_syncs=syncs, max_abs_err=err,
        held_to="the unsharded fused scheduled run's planes")
    print(f"[shard] data fused scheduled: {b} zipf systems through "
          f"{resident} lanes over {shards} shards (one scheduling group a "
          f"shard): {launches} K2 launches, {syncs} host sync, "
          f"{eng.occupancy.intervals} intervals; planes equal to the "
          f"unsharded run: max_abs_err={err}")

    # the node axis of the general engine over NCCL
    def cfg_of(n):
        return SystemConfig(num_procs=n, msg_buffer_size=16,
                            semantics=Semantics().robust())

    ladder = [2, 4] if cards >= 4 else ([min(4, cards)] if cards >= 2
                                        else [1])
    for node in ladder:
        t0 = time.perf_counter()
        engs, refs = _node_jobs(cfg_of, node, "cuda")
        secs = time.perf_counter() - t0
        for e, ref in zip(engs, refs):
            same = (e.cycle == ref.cycle
                    and e.snapshots() == ref.snapshots()
                    and e.final_dumps() == ref.final_dumps()
                    and e.stats()["instructions"] == ref.instructions
                    and e.messages == ref.messages)
            plan = exchange.make_plan(node, e.config.exchange_mode)
            want = dict(exchange.plan_collectives(plan),
                        sum=1, max=1 if node > 1 else 0, min=0)
            coll = e.step_collectives
            if not same or coll != want:
                raise AssertionError(
                    f"shard node {node} {e.config.exchange_mode} "
                    f"{e.config.num_procs} nodes: equal {same}, "
                    f"collectives {coll} != {want}")
            st = e.rank_stats
            ms_step = max(r["seconds"] for r in st) * 1e3 / max(
                st[0]["steps"], 1)
            print(f"[shard] node: {e.config.num_procs} nodes over {node} "
                  f"NCCL rank(s) (one card each), {e.config.exchange_mode}:"
                  f" {e.cycle} cycles, equal to TorchEngine on the card "
                  f"(cycle, snapshots, dumps, counters); collectives a "
                  f"cycle {coll} (plan {exchange.plan_collectives(plan)} + "
                  f"SUM + MAX), {ms_step:.3f} ms a step uncaptured")
        print(f"[shard] node: {len(engs)} runs over {node} rank(s) in "
              f"{secs:.1f} s with the ranks' start")
    if cards < 2:
        print("[shard] node: one card: the run above is one NCCL rank "
              "through parallel/launch.py; the multi-rank exchange needs "
              "two cards (NCCL takes one rank a card); the four-card run "
              "of this phase is recorded in PERF.md section 6 (the "
              "multi-GPU slice's findings)")
    return k2, k3


#: ``[nodeshard]``'s runs: the 64-node shape of ``scale_runs.py
#: nodeshard`` at a cut depth (8 instructions a core where the ladder
#: has 64), a fused packed zipf run at 12 nodes (packed planes hold at
#: most 14: the directory meta word is 2 + num_procs bits of 16) and a
#: served feed at 16 nodes
NODESHARD = dict(num_procs=64, msg_buffer_size=16, max_instr_num=0)
NODESHARD_RUN = dict(block=512, cycles_per_call=64, snapshots=False,
                     trace_window=16)
NODESHARD_INSTRS = 8
NODESHARD_ZIPF = (12, 512, 256)      # nodes, systems, resident lanes
NODESHARD_SERVE = (16, 256, 128)     # nodes, jobs, resident lanes
#: cycles of the profiled call (the profiler's own processing grows
#: with the events it records)
NODESHARD_PROFILE_K = 4


def phase_nodeshard():
    """``[nodeshard]``: the fast path's node axis
    (``NodeShardedCudaEngine``, ``NodeShardedLaneSession``) over NCCL
    ranks, one a card.  With one card it prints that the path needs two
    and runs nothing (NCCL takes one rank a card).  With two or more:
    64 nodes x 1,024 systems x 8 instructions (block 512, window 16, k
    64, snapshots off) over 4 ranks (a2a and pairwise) and a 2 x 2
    data x node grid on four cards, over 2 ranks (a2a) on two or three,
    all in the served feed's group of ranks, each run twice there (an
    untimed run, whose first k-cycle call in the first engine holds
    every N1-N4 launch against its plain version, then the timed run),
    each run's gathered planes (cycle and counters among them) equal
    to K2's run of the same arrays on ``cuda:0`` (max_abs_err 0); the
    CUDA kernels a cycle
    by ``torch.profiler``; a fused scheduled zipf run (12 nodes, 512
    systems through 256 lanes, packed) equal to ``CudaEngine``'s; and a
    served feed through ``NodeShardedLaneSession`` (16 nodes, 256 jobs
    through 128 lanes) whose every job's dumps equal
    ``CudaLaneSession``'s.  Returns its record."""
    import dataclasses

    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
    from hpa2_tpu_torch.ops.schedule import Schedule
    from hpa2_tpu_torch.parallel import (
        NodeShardedCudaEngine, NodeShardedLaneSession, make_mesh,
    )
    from hpa2_tpu_torch.parallel.sharding import NodeProfile, run_node_sharded
    from hpa2_tpu_torch.serving import ListJobSource, serve, synthetic_jobs
    from hpa2_tpu_torch.serving.loop import ServingSession
    from hpa2_tpu_torch.utils.trace import (
        gen_heterogeneous_random_arrays, gen_uniform_random_arrays,
    )

    cards = torch.cuda.device_count()
    if cards < 2:
        print("[nodeshard] one card: the fast path's node axis needs two "
              "cards or more (NCCL takes one rank a card), so nothing runs "
              "here; its four-card run is recorded in PERF.md section 6")
        return {"cards": cards}
    t_phase = time.perf_counter()
    robust = Semantics().robust()
    cfg = SystemConfig(semantics=robust, **NODESHARD)
    arrays = gen_uniform_random_arrays(cfg, 1024, NODESHARD_INSTRS, seed=0)
    ref = CudaEngine(cfg, *arrays, **NODESHARD_RUN)
    ref.run()
    _, k2_ms = elapsed_ms(lambda: CudaEngine(cfg, *arrays,
                                             **NODESHARD_RUN).run())
    want = ref.state
    rec = {"cards": cards, "k2_ms": round(k2_ms, 3), "runs": {}}
    print(f"[nodeshard] K2 on cuda:0: 64 nodes x 1024 x "
          f"{NODESHARD_INSTRS} (cut from 64 instructions a core), "
          f"{ref.cycle} cycles, {k2_ms:.3f} ms engine run")

    def mesh(node, data=1):
        return make_mesh(node_shards=node, data_shards=data, device="cuda")

    # one group of ranks for every run: four on four cards (the 2 x 2
    # grid's node groups are the two-rank exchange), else two
    top = 4 if cards >= 4 else 2
    # the first run's first k-cycle call holds every node-kernel launch
    # against its plain version (the tensor cycle) on the same inputs
    if top == 4:
        engs = {
            "4 ranks a2a": NodeShardedCudaEngine(
                cfg, *arrays, mesh=mesh(4), _check_calls=1,
                **NODESHARD_RUN),
            "4 ranks pairwise": NodeShardedCudaEngine(
                dataclasses.replace(cfg, exchange_mode="pairwise"),
                *arrays, mesh=mesh(4), **NODESHARD_RUN),
            "2 x 2 grid": NodeShardedCudaEngine(
                cfg, *arrays, mesh=mesh(2, 2), **NODESHARD_RUN)}
    else:
        engs = {"2 ranks a2a": NodeShardedCudaEngine(
            cfg, *arrays, mesh=mesh(2), _check_calls=1, **NODESHARD_RUN)}
    zn, zb, zr = NODESHARD_ZIPF
    zcfg = SystemConfig(num_procs=zn, msg_buffer_size=16, semantics=robust)
    zarrays = gen_heterogeneous_random_arrays(zcfg, zb, 32, dist="zipf",
                                              spread=4.0, seed=3)
    zkw = dict(NODESHARD_RUN, block=128, cycles_per_call=16,
               schedule=Schedule(resident=zr), packed=True)
    zref = CudaEngine(zcfg, *zarrays, **zkw).run()
    engs["fused zipf packed"] = NodeShardedCudaEngine(
        zcfg, *zarrays, mesh=mesh(top), **zkw)
    prof = NodeProfile(engs[f"{top} ranks a2a"], k=NODESHARD_PROFILE_K)

    # the served feed's one-card reference
    sn, sj, sr = NODESHARD_SERVE
    scfg = SystemConfig(num_procs=sn, msg_buffer_size=16, semantics=robust)
    jobs = synthetic_jobs(scfg, sj, 32, seed=7, dist="zipf", spread=4.0)
    want_res, _ = serve(scfg, ListJobSource(jobs), resident=sr, window=16,
                        block=128, device="cuda")

    # the session's ranks run the engines too: one start for the phase
    t0 = time.perf_counter()
    sess = NodeShardedLaneSession(scfg, sr, 16, node_shards=top, block=128,
                                  cycles_per_call=16, device="cuda")
    with sess:
        start_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        # each engine runs twice in the ranks: the first run pays the
        # ranks' one-time costs (the first NCCL calls of its groups) and
        # holds the checked call, the second is timed
        run_node_sharded(list(engs.values()) + [prof], pool=sess.pool,
                         warmup=True)
        secs = time.perf_counter() - t0
        for name, e in engs.items():
            other = zref.state if name.startswith("fused") else want
            err = check_diff(f"nodeshard {name}", plane_diff(
                e.config, False, {f: v.cuda() for f, v in e.state.items()},
                other, packed=e._packed))
            if name.startswith("fused") and (
                    e.occupancy.as_dict() != zref.occupancy.as_dict()):
                raise AssertionError("nodeshard fused: occupancy differs")
            slow = max(e.rank_stats, key=lambda r: r["seconds"])
            st = e.rank_stats[0]
            ms_cycle = slow["seconds"] * 1e3 / max(slow["cycles"], 1)
            stats = e.stats()
            row = dict(
                cycles=e.cycle, cycles_run=st["cycles"], calls=st["calls"],
                ms_per_cycle=round(ms_cycle, 3),
                rank_seconds=round(slow["seconds"], 3),
                collectives_per_cycle=st["census"]["cycle"],
                host_syncs=st["host_syncs"],
                cross_shard_msgs=e.cross_shard_msgs,
                exchange_bytes_per_cycle=stats.get(
                    "exchange_bytes_per_cycle", 0),
                max_abs_err=err)
            rec["runs"][name] = row
            held = ("CudaEngine's fused run" if name.startswith("fused")
                    else "K2's run on cuda:0")
            print(f"[nodeshard] {name} ({e.config.num_procs} nodes, "
                  f"{e.config.exchange_mode}): {e.cycle} cycles "
                  f"({st['cycles']} run in {st['calls']} calls), "
                  f"{ms_cycle:.3f} ms a cycle (slowest rank), collectives "
                  f"a cycle {st['census']['cycle']}, {st['host_syncs']} "
                  f"host syncs, {e.cross_shard_msgs} cross-shard msgs, "
                  f"{row['exchange_bytes_per_cycle']} exchange B a cycle; "
                  f"planes equal to {held}: max_abs_err={err}")
        print(f"[nodeshard] {len(engs)} run(s) over {top} ranks in "
              f"{secs:.1f} s, after the ranks' start in {start_s:.1f} s")
        launches = {k: 0 for k in engs[f"{top} ranks a2a"].rank_stats[0][
            "launches"]}
        checked = {k: [0, 0] for k in launches}
        for e in engs.values():
            for st in e.rank_stats:
                for k in launches:
                    launches[k] += st["launches"][k]
                    checked[k][0] += st["checked"][k][0]
                    checked[k][1] = max(checked[k][1], st["checked"][k][1])
        if not all(launches.values()) or not all(
                c for c, _ in checked.values()) or any(
                x for _, x in checked.values()):
            raise AssertionError(
                f"nodeshard: node kernels {launches}, checked {checked}")
        rec["node_launches"], rec["checked"] = launches, checked
        print(f"[nodeshard] node kernel launches (every rank, timed runs): "
              f"{launches}; the first run's first k-cycle call (untimed) "
              f"held against the tensor cycle launch by launch: {checked} "
              "(launches checked, max_abs_err)")
        rec["cuda_launches_per_cycle"] = prof.per_cycle["kernels"]
        rec["nccl_per_cycle"] = prof.per_cycle["nccl"]
        rec["launch_calls_per_cycle"] = prof.per_cycle["launch_calls"]
        print(f"[nodeshard] torch.profiler over one k-cycle call on each "
              f"of {top} ranks: {rec['cuda_launches_per_cycle']} CUDA "
              f"kernels a cycle (most on a rank; the tensor cycle's: "
              f"1,738.5, PERF.md), {rec['nccl_per_cycle']} of them NCCL; "
              f"{rec['launch_calls_per_cycle']} kernel launch calls a cycle "
              "on the host")

        # a served feed: every job's dumps equal the one-card session's
        t0 = time.perf_counter()
        got_res, st = ServingSession(sess, ListJobSource(jobs)).run()
        secs = time.perf_counter() - t0
    wanted = {r.job_id: _dump_dicts(r.dumps) for r in want_res}
    got = {r.job_id: _dump_dicts(r.dumps) for r in got_res}
    if got != wanted:
        raise AssertionError("nodeshard serve: dumps differ from "
                             "CudaLaneSession's")
    xmsgs = sum(r.counters["cross_shard_msgs"] for r in got_res)
    rec["serve"] = dict(jobs=sj, seconds=round(secs, 3),
                        cross_shard_msgs=xmsgs,
                        compile_counts=st.compile_counts)
    print(f"[nodeshard] serve: {sj} zipf jobs x {sn} nodes through {sr} "
          f"lanes over {top} ranks (the same ranks) in {secs:.1f} s, "
          f"{xmsgs} cross-shard msgs; every job's dumps equal to "
          f"CudaLaneSession's; compile counts {st.compile_counts}")
    rec["seconds"] = round(time.perf_counter() - t_phase, 1)
    print(f"[nodeshard] phase {rec['seconds']} s (budget 90 s on four "
          "cards)")
    return rec


def host_cpu() -> str:
    """The host's CPU as ``/proc/cpuinfo`` gives it for its first
    processor: model name, vendor, family and model, clock and cache
    (a virtualised host may report the model name as "unknown"; the
    family, model and clock still tell machines apart),
    and the core count."""
    import platform

    info = {}
    with contextlib.suppress(OSError):
        for line in pathlib.Path("/proc/cpuinfo").read_text().splitlines():
            if not line.strip():
                break
            key, _, val = line.partition(":")
            info[key.strip()] = val.strip()
    if not info:
        return f"{platform.machine() or 'unknown'}, {os.cpu_count()} cores"
    return (f"{info.get('model name', 'unknown')} ({info.get('vendor_id', '?')}"
            f" family {info.get('cpu family', '?')} model "
            f"{info.get('model', '?')}, {info.get('cpu MHz', '?')} MHz, "
            f"cache {info.get('cache size', '?')}), {os.cpu_count()} cores")


def phase_analysis(budget_rows):
    """``[analysis]``: ``python -m hpa2_tpu_torch.analysis``'s checks on
    the card.  ``equiv`` on the semantics sets ``check`` uses: the
    ``pallas`` prober, one cycle of K3 with every probeable MESI row a
    lane of one launch, each launch held against the plain version on a
    copy of its planes; ``spec``, ``jax`` (the general engine's step on
    the card) and ``native`` at MESI and ``jax`` at MOESI and MESIF, with
    the multi-message diffs; every table diff 0.  Then ``contracts`` on
    the card (the 8 unsharded points and ``data-sharded-pallas`` clean,
    the wrappers' calls equal to the libraries' launches, the three
    node-sharded points, the fast path's and the general engine's two,
    clean on four cards and skipped on fewer), ``elision``'s verify against ``TorchEngine`` on the
    card, ``lint`` and ``mutation-test``.  ``budget_rows`` is the count
    of ``[build]`` rows whose shared memory the Hopper budget model
    matched.  Returns K3's ``by_path`` record."""
    from hpa2_tpu_torch.analysis import contracts, elision, extract, ir
    from hpa2_tpu_torch.analysis.lint import run_lint
    from hpa2_tpu_torch.analysis.mutate import run_all_mutations
    from hpa2_tpu_torch.analysis.table import build_table
    from hpa2_tpu_torch.config import Semantics
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.call_run import call_plain
    from hpa2_tpu_torch.ops.layout import _SC_INSTR, _SC_MSGS

    sems = {"default": Semantics(), "robust": Semantics().robust()}
    rows = {}
    for kern in kernels.LIBRARIES:
        kern.launches = 0
    with checked_kernels("analysis prober") as rec:
        for name, sem in sems.items():
            table = build_table(sem, "mesi")
            prober = extract.PallasProber(sem, device="cuda")
            diffs = extract.diff_backend(table, "pallas", prober=prober)
            rows[name] = len(extract.probeable_rows(table))
            if diffs:
                raise AssertionError(f"analysis equiv {name}/mesi pallas: "
                                     + "; ".join(diffs[:5]))
            print(f"[analysis] equiv {name}/mesi pallas: {rows[name]} rows "
                  f"as the lanes of {prober.launches} K3 launch, 0 diffs")
    launches = {k.name: k.launches for k in kernels.LIBRARIES}
    if launches["call_run"] != len(sems) or launches["stream_run"] \
            or rec["call_run"] != launches["call_run"]:
        raise AssertionError(f"analysis prober: launches {launches}, "
                             f"checked {rec['call_run']}")
    print(f"[analysis] prober: {launches['call_run']} K3 launches, each "
          f"held against the plain version plane for plane: "
          f"max_abs_err={rec['err']}")

    # the probe launch alone, timed, on the robust rows' planes
    sem = sems["robust"]
    prober = extract.PallasProber(sem, device="cuda")
    scns = [extract.scenario_for(r)
            for r in extract.probeable_rows(build_table(sem))]
    state, tr, tl = prober.staged(scns)
    kw = dict(seg=0, block=len(scns), k=1, window=1, gate=False,
              snapshots=False)
    times = []
    for _ in range(20):
        got = {f: v.clone() for f, v in state.items()}
        _, t = elapsed_ms(lambda: kernels.call_run(prober.cfg, got, tr, tl,
                                                   **kw))
        times.append(t)
    ms = sum(times[1:]) / (len(times) - 1)
    want, plain_ms = elapsed_ms(lambda: call_plain(prober.cfg, state, tr, tl,
                                                   **kw))
    err = check_diff("analysis probe", plane_diff(prober.cfg, False, got,
                                                  want))
    state_bytes = sum(v.numel() * v.element_size() for v in state.values())
    moved = 2 * state_bytes + (tr.numel() + tl.numel()) * 4
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    sc = got["scalars"].long()
    ops = cycle_ops(prober.cfg.num_procs, len(scns),
                    int(sc[_SC_MSGS].sum()), int(sc[_SC_INSTR].sum()))
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    print(f"[analysis] probe launch: {len(scns)} lanes x "
          f"{prober.cfg.num_procs} nodes, one cycle: kernel {ms:.4f} ms "
          f"(mean of 19 after one warm-up), plain {plain_ms:.1f} ms, "
          f"max_abs_err={err}; bound: bytes {moved} B / 3.35 TB/s = "
          f"{bytes_ms:.6f} ms, operations {ops} = {ops_ms:.6f} ms")

    # the other backends, on the card where they have a device
    k3 = kernels.CALL_RUN.launches
    for name, sem in sems.items():
        for proto in ("mesi", "moesi", "mesif"):
            table = build_table(sem, proto)
            for backend in (("spec", "jax", "native") if proto == "mesi"
                            else ("jax",)):
                diffs = extract.diff_backend(table, backend, device="cuda")
                if diffs:
                    raise AssertionError(
                        f"analysis equiv {name}/{proto} {backend}: "
                        + "; ".join(diffs[:5]))
            multi = extract.diff_multi_backend(sem, proto, device="cuda")
            if multi:
                raise AssertionError(f"analysis equiv {name}/{proto} "
                                     "multi: " + "; ".join(multi[:5]))
            print(f"[analysis] equiv {name}/{proto}: "
                  f"{'spec, jax, native' if proto == 'mesi' else 'jax'} "
                  "and the multi-message spec<->jax diff: 0 diffs")
    if kernels.CALL_RUN.launches != k3:
        raise AssertionError("the jax/spec/native probes launched K3")

    # contracts on the card
    with ir.launch_census() as census:
        results = contracts.run_contracts(
            device="cuda", out=lambda line: print(f"[analysis] {line}"))
    status = {r.contract: r.status for r in results}
    clean = [c for c, v in status.items() if v == "ok"]
    skipped = [r for r in results if r.status == "skip"]
    # the three node-sharded points spawn four NCCL ranks: four cards,
    # else skipped
    four = torch.cuda.device_count() >= 4
    if len(clean) != (12 if four else 9) \
            or len(skipped) != (0 if four else 3) or any(
                "needs 4 cards" not in r.note for r in skipped):
        raise AssertionError(f"analysis contracts: {status}")
    for name in ("stream_run", "call_run"):
        if census[f"calls.{name}"] != census[f"launches.{name}"]:
            raise AssertionError(f"analysis contracts: {census}")
    print(f"[analysis] contracts: {len(clean)} clean on the card, "
          f"{len(skipped)} skipped (" + "; ".join(
              f"{r.contract}: {r.note}" for r in skipped) + "); wrapper "
          f"calls = launches: stream_run "
          f"{census['launches.stream_run']}, call_run "
          f"{census['launches.call_run']}; {census['host_syncs']} host syncs")
    print(f"[analysis] Hopper budget: the model's shared memory, threads "
          f"and cluster equal the card's for all {budget_rows} [build] rows")

    text, rc = elision.elision_table(device="cuda")
    for line in text.splitlines():
        print(f"[analysis] {line}")
    if rc:
        raise AssertionError("analysis elision: model != TorchEngine")
    findings = run_lint(str(ROOT))
    if findings:
        raise AssertionError(f"analysis lint: {findings[:5]}")
    missed = [f"{p}/{r.name}" for p in ("mesi", "moesi", "mesif")
              for r in run_all_mutations(Semantics(), p) if not r.caught]
    if missed:
        raise AssertionError(f"analysis mutation-test missed {missed}")
    print("[analysis] elision: model = TorchEngine on the card; lint: 0 "
          "findings; mutation-test: 36/36 caught")
    return dict(launches=launches["call_run"],
                checked_launches=rec["call_run"],
                max_abs_err=max(rec["err"], err), ms=ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                rows=sum(rows.values()))


#: ``[nodekern]``'s runs, one card, the ranks logical (threads of this
#: process on ``cuda:0``, ``make_mesh(..., local=True)``): name, nodes,
#: systems, instructions a core, ranks, exchange schedule, packed.  The
#: 64-node runs are ``[nodeshard]``'s shape; packed planes hold at most
#: 14 nodes, so the packed run is at 12; 22 nodes split the sharer planes
NODEKERN_RUNS = (
    ("64 nodes 2 ranks a2a", 64, 1024, NODESHARD_INSTRS, 2, "a2a", False),
    ("64 nodes 2 ranks pairwise", 64, 1024, NODESHARD_INSTRS, 2,
     "pairwise", False),
    ("12 nodes packed 2 ranks", 12, 1024, 16, 2, "a2a", True),
    ("22 nodes split 2 ranks", 22, 1024, 16, 2, "a2a", False),
    ("64 nodes 4 ranks a2a", 64, 1024, NODESHARD_INSTRS, 4, "a2a", False),
    ("64 nodes 4 ranks pairwise", 64, 1024, NODESHARD_INSTRS, 4,
     "pairwise", False),
    ("64 nodes 4 ranks butterfly", 64, 1024, NODESHARD_INSTRS, 4,
     "butterfly", False),
    ("64 nodes 4 ranks hier", 64, 1024, NODESHARD_INSTRS, 4, "hier",
     False),
)
#: the cycle of the timed call whose stage inputs time each kernel
NODEKERN_KEEP_AT = 8
#: the wide family's runs of ``[nodekern]`` over 4 logical ranks, a2a:
#: (name, nodes, systems, instructions a core, cycles a call, the first
#: of them checked); 256 nodes held against the general engine
#: (snapshots on, no windows), and the node axis's own geometry,
#: ``gpu_session``'s ``nodeshard4096`` widths with 2 instructions a core
#: (cut from 32 for time) and 2-cycle calls (a checked cycle of its four
#: ranks is ~3 s of plain versions)
NODEKERN_WIDE_RUNS = (
    ("256 nodes 4 ranks a2a", 256, 256, 4, 8),
    ("4096 nodes 4 ranks a2a", 4096, 8, 2, 2),
)
#: the cycle of a 4-cycle call at 4,096 nodes whose stage inputs time
#: each wide kernel, and the reps of those timings
NODEKERN_WIDE_KEEP_AT = 2
NODEKERN_WIDE_REPS = 3
#: cycles a call of ``[nodekern]``'s runs (``[nodeshard]``'s 64 cut for
#: time: the first call's launches are each held against their plain
#: versions, ~27 ms a cycle a rank of plain work at 64 nodes; 16 since
#: the wide family's runs joined the phase)
NODEKERN_K = 16


def _node_rank_setup(job):
    """This logical or NCCL rank's node block of an engine's initial
    planes and first trace window, on its device."""
    from hpa2_tpu_torch.ops.cycle import TRANSIENTS
    from hpa2_tpu_torch.ops.layout import _init_state
    from hpa2_tpu_torch.parallel.comm import world_comm
    from hpa2_tpu_torch.parallel.sharding import _node_local, _rank_device

    eng = job["engine"]
    cfg = eng.config
    comm, _ = world_comm(job["mesh"].node)
    dev = _rank_device(job["mesh"])
    nl = cfg.num_procs // comm.size
    node = slice(comm.rank * nl, (comm.rank + 1) * nl)
    tr = eng._tr_full[node][:, :eng._window].contiguous().to(dev)
    tl = eng._tr_len_full[node].clamp(max=eng._window).contiguous().to(dev)

    def planes():
        st = _node_local(_init_state(cfg, tr.shape[-1], False, eng._packed),
                         comm.rank, nl, slice(None), dev)
        trans = {f: torch.zeros((1, tr.shape[-1]), dtype=torch.int32,
                                device=dev) for f in TRANSIENTS}
        return st, trans
    return comm, tr, tl, planes


def _nodekern_time_rank(job):
    """One k-cycle call on every logical rank, the inputs of each node
    kernel at cycle ``NODEKERN_KEEP_AT`` kept; then rank 0 times each
    kernel and its plain version on them while the others wait."""
    from hpa2_tpu_torch.parallel.sharding import NodeInterval

    comm, tr, tl, planes = _node_rank_setup(job)
    eng = job["engine"]
    prog = NodeInterval(eng.config, comm, False, eng._window,
                        job.get("k", eng.cycles_per_call), 1,
                        packed=eng._packed)
    prog.cycle.keep_at = job.get("keep_at", NODEKERN_KEEP_AT)
    prog(*planes(), tr, tl)
    comm.barrier()
    out = (prog.cycle.time_kept(reps=job.get("reps", 10))
           if comm.rank == 0 else None)
    comm.barrier()
    return dict(planes={}, status=0, times=out)


class _NodeJob:
    """A job for ``run_node_sharded``: ``fn`` on every rank of an
    engine's mesh; ``rows`` the ranks' answers."""

    def __init__(self, fn, engine, **extra):
        self.fn, self.engine, self.mesh = fn, engine, engine.mesh
        self.extra = extra
        self.rows = []

    def _job(self):
        return dict(rank_fn=self.fn, engine=self.engine, mesh=self.mesh,
                    config=self.engine.config, **self.extra)

    def _gather(self, blocks):
        self.rows = blocks

    def _check(self):
        pass


def phase_nodekern():
    """``[nodekern]``: K1's node-sharded cycle as its four kernels (N1
    ``node_ab``, N2 ``node_bucket``, N3 ``node_deliver``, N4
    ``node_settle``, ``ops/node_cycle.py``) on ONE card, the node ranks
    logical (``make_mesh(..., local=True)``: threads of this process on
    ``cuda:0`` meeting through ``parallel/comm.py:LocalComm``).  The
    runs of :data:`NODEKERN_RUNS` (64 nodes x 1,024 systems x 8
    instructions, window 16, k 16 (:data:`NODEKERN_K`), over 2 and 4
    ranks, a2a and pairwise,
    butterfly at 4; 12 nodes packed and 22 split over 2), each run twice
    in its ranks: a first run whose first k-cycle call holds every N1-N4
    launch against its plain version on the same inputs (max_abs_err
    0), then the timed run; each run's gathered planes equal to K2's run
    of the same arrays (max_abs_err 0).  Then the CUDA kernels a cycle
    (``torch.profiler``) of one 4-cycle call at 64 nodes over 2 and 4
    ranks, and each kernel's and plain version's time on the inputs of
    cycle 8 of a 64-node a2a call over 2 ranks and over 4 (a rank's
    entries and receivers differ); and the wide family's runs
    (:func:`nodekern_wide`).  Returns its record."""
    import dataclasses

    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.ops import node_cycle
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
    from hpa2_tpu_torch.parallel import NodeShardedCudaEngine, make_mesh
    from hpa2_tpu_torch.parallel.sharding import NodeProfile, run_node_sharded
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    t_phase = time.perf_counter()
    robust = Semantics().robust()
    refs, engs = {}, {}
    for name, n, b, t, d, mode, packed in NODEKERN_RUNS:
        cfg = SystemConfig(num_procs=n, msg_buffer_size=16, semantics=robust,
                           max_instr_num=0, exchange_mode=mode)
        arrays = gen_uniform_random_arrays(cfg, b, t, seed=n)
        kw = dict(NODESHARD_RUN, packed=packed, cycles_per_call=NODEKERN_K)
        key = (n, b, t, packed)
        if key not in refs:
            refs[key] = CudaEngine(dataclasses.replace(
                cfg, exchange_mode="a2a"), *arrays, **kw).run()
        engs[name] = (NodeShardedCudaEngine(
            cfg, *arrays, mesh=make_mesh(node_shards=d, device="cuda",
                                         local=True),
            _check_calls=1, **kw), refs[key])
    secs_setup = time.perf_counter() - t_phase
    for e in node_cycle.NODE_KERNELS:
        e.launches = 0
    t0 = time.perf_counter()
    for name, (e, _) in engs.items():
        t1 = time.perf_counter()
        run_node_sharded([e], warmup=True)
        print(f"[nodekern] {name}: ran twice in its ranks in "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
    secs = time.perf_counter() - t0
    launches = {e.name: e.launches for e in node_cycle.NODE_KERNELS}
    if not all(launches.values()):
        raise AssertionError(f"nodekern: a node kernel never ran: {launches}")
    rec = {"runs": {}, "launches": launches, "seconds_runs": round(secs, 1)}
    checked = {e.name: [0, 0] for e in node_cycle.NODE_KERNELS}
    err_all = 0
    for name, (e, ref) in engs.items():
        err = check_diff(f"nodekern {name}", plane_diff(
            e.config, False, {f: v.cuda() for f, v in e.state.items()},
            ref.state, packed=e._packed))
        err_all = max(err_all, err)
        for st in e.rank_stats:
            for k, (c, x) in st["checked"].items():
                checked[k][0] += c
                checked[k][1] = max(checked[k][1], x)
        slow = max(e.rank_stats, key=lambda r: r["seconds"])
        ms = slow["seconds"] * 1e3 / max(slow["cycles"], 1)
        per = {k: v for k, v in e.rank_stats[0]["launches"].items()}
        comb = e.stats().get("exchange_combined", 0)
        rec["runs"][name] = dict(cycles=e.cycle, cycles_run=slow["cycles"],
                                 ms_per_cycle=round(ms, 3), max_abs_err=err,
                                 node_launches_rank0=per, combined=comb)
        print(f"[nodekern] {name} ({e.config.num_procs} nodes x "
              f"{e.b} x {e.config.exchange_mode}, {e.mesh.node} logical "
              f"ranks on cuda:0): {e.cycle} cycles ({slow['cycles']} run), "
              f"{ms:.3f} ms a cycle (timed run, slowest rank), rank 0's "
              f"launches {per}; combining count {comb}; planes equal to "
              f"K2's run: max_abs_err={err}")
    for k, (c, x) in checked.items():
        if c == 0 or x:
            raise AssertionError(f"nodekern: {k} checked {c}, err {x}")
    rec["checked"] = checked
    rec["max_abs_err"] = err_all
    print(f"[nodekern] every launch of each run's first k-cycle call held "
          f"against its plain version on the same inputs: {checked} "
          "(launches checked, max_abs_err)")

    # the CUDA kernels a cycle: one 4-cycle call (the window's seed and
    # gates included) at 64 nodes over 2 and 4 logical ranks
    rec["profile"] = {}
    t_prof = time.perf_counter()
    for d in (2, 4):
        prof = NodeProfile(engs[f"64 nodes {d} ranks a2a"][0],
                           k=NODESHARD_PROFILE_K)
        run_node_sharded([prof])
        rec["profile"][d] = prof.per_cycle
        print(f"[nodekern] torch.profiler over one {NODESHARD_PROFILE_K}-"
              f"cycle call at 64 nodes over {d} logical ranks: "
              f"{prof.per_cycle['kernels']} CUDA kernels a cycle a rank "
              f"(the tensor cycle's: 1,738.5 a rank over NCCL, PERF.md), "
              f"{prof.per_cycle['launch_calls']} kernel launch calls a "
              f"cycle a rank, {prof.per_cycle['device_us']} us of device "
              "time a cycle a rank (every kernel but NCCL's), of which the "
              f"node kernels' {prof.per_cycle['node_us']}")

    # each kernel and its plain version on cycle 8's inputs, over 2
    # ranks (the kernels line's times) and over 4
    t_time = time.perf_counter()
    for d in (2, 4):
        job = _NodeJob(_nodekern_time_rank, engs[f"64 nodes {d} ranks a2a"][0])
        run_node_sharded([job])
        times = next(r["times"] for r in job.rows if r["times"])
        key = "times" if d == 2 else "times_4_ranks"
        rec[key] = {}
        for k, tm in times.items():
            bound = tm["bytes"] / HBM_BYTES_PER_S * 1e3
            grid = tm["grid"]
            rec[key][k] = dict(ms=round(tm["ms"], 4),
                               wrapper_ms=round(tm["wrapper_ms"], 4),
                               plain_ms=round(tm["plain_ms"], 4),
                               bound_ms=round(bound, 6), bytes=tm["bytes"],
                               grid=grid, empty_ms=round(tm["empty_ms"], 4))
            print(f"[nodekern] {k}: {tm['ms']:.4f} ms a launch (CUDA "
                  f"events around the launch alone, median of 10, 64 "
                  f"nodes x 1,024 over {d} ranks, cycle "
                  f"{NODEKERN_KEEP_AT}'s inputs; the whole wrapper "
                  f"{tm['wrapper_ms']:.4f}), plain version "
                  f"{tm['plain_ms']:.4f} ms, bound {bound:.6f} ms "
                  f"({tm['bytes']} B over 3.35 TB/s); grid {grid['ctas']} "
                  f"CTAs of {grid['threads']} threads ({grid['lanes']} "
                  f"lanes, {grid['smem']} B shared each, "
                  f"{grid['ctas_per_sm']} an SM at once) on "
                  f"{grid['sms_covered']} of {grid['sms']} SMs; an empty "
                  f"launch of that grid {tm['empty_ms']:.4f} ms)")
    t_wide = time.perf_counter()
    rec["wide"] = nodekern_wide()
    rec["ptxas"] = node_ptxas()
    for k, rows in rec["ptxas"].items():
        print(f"[nodekern] {k} ptxas: " + "; ".join(
            f"{inst} {r['registers']} registers, {r['stack']} B frame, "
            f"{r['spill_stores']}/{r['spill_loads']} B spilled"
            for inst, r in rows.items()))
    t_end = time.perf_counter()
    rec["seconds"] = round(t_end - t_phase, 1)
    rec["seconds_by_part"] = parts = dict(
        setup=round(secs_setup, 1), runs=round(secs, 1),
        checks=round(t_prof - t0 - secs, 1),
        profile=round(t_time - t_prof, 1), timings=round(t_wide - t_time, 1),
        wide=round(t_end - t_wide, 1))
    print(f"[nodekern] phase {rec['seconds']} s (budget 90 s): K2's "
          f"references and the engines {parts['setup']} s, the runs "
          f"{parts['runs']}, their checks against K2 {parts['checks']}, "
          f"the profile {parts['profile']}, the kernel timings and grids "
          f"{parts['timings']}, the wide family's runs and timings and the "
          f"ptxas rows {parts['wide']}")
    return rec


def nodekern_wide():
    """``[nodekern]``'s wide family (``node_*_wide``, above 64 nodes) over
    4 logical ranks on one card, the runs of :data:`NODEKERN_WIDE_RUNS`:
    each run's first call holds every launch against its plain version
    (max_abs_err 0) and retires every instruction; the 256-node run's
    dumps, snapshots, per-system counters and cycle equal the general
    engine's (``build_batched_run``) on the same arrays; each wide
    kernel and its plain version timed alone on cycle
    ``NODEKERN_WIDE_KEEP_AT``'s inputs at 4,096 nodes.  The launch counts
    are zeroed just before the runs and read just after.  Returns its
    record."""
    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.ops import node_cycle
    from hpa2_tpu_torch.parallel import NodeShardedCudaEngine, make_mesh
    from hpa2_tpu_torch.parallel.sharding import run_node_sharded
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    rec = {"runs": {}}
    engs = {}
    for name, n, b, t, k in NODEKERN_WIDE_RUNS:
        cfg = SystemConfig(num_procs=n, msg_buffer_size=16,
                           semantics=Semantics().robust(), max_instr_num=0)
        arrays = gen_uniform_random_arrays(cfg, b, t, seed=n)
        engs[name] = (cfg, arrays, NodeShardedCudaEngine(
            cfg, *arrays, mesh=make_mesh(node_shards=4, device="cuda",
                                         local=True),
            block=b, cycles_per_call=k, snapshots=n == 256,
            _check_calls=1))
    for e in node_cycle.WIDE_KERNELS:
        e.launches = 0
    for name, (_, _, eng) in engs.items():
        t1 = time.perf_counter()
        run_node_sharded([eng])
        print(f"[nodekern] {name}: ran in its ranks in "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
    launches = {e.name: e.launches for e in node_cycle.WIDE_KERNELS}
    if not all(launches.values()):
        raise AssertionError(f"nodekern: a wide kernel never ran: {launches}")
    rec["launches"] = launches
    checked = {e.name: [0, 0] for e in node_cycle.WIDE_KERNELS}
    err_all = 0
    for name, (cfg, arrays, eng) in engs.items():
        for st in eng.rank_stats:
            for k, (c, x) in st["checked"].items():
                checked[k][0] += c
                checked[k][1] = max(checked[k][1], x)
        if eng.instructions != int(arrays[3].sum()):
            raise AssertionError(f"nodekern {name}: {eng.instructions} "
                                 f"instructions of {int(arrays[3].sum())}")
        slow = max(eng.rank_stats, key=lambda r: r["seconds"])
        row = dict(cycles=eng.cycle, instructions=eng.instructions,
                   ms_per_cycle_first_call_checked=round(
                       slow["seconds"] * 1e3 / max(slow["cycles"], 1), 3),
                   node_launches_rank0=eng.rank_stats[0]["launches"])
        if cfg.num_procs == 256:
            got, grec = run_general(f"nodekern {name}", cfg, arrays,
                                    "(the wide family's reference)")
            err = state_err(f"nodekern {name} against the general engine",
                            general_as_k2_arrays(got),
                            k2_planes_as_arrays(cfg, eng.state))
            if int(got["cycle"].max()) != eng.cycle:
                raise AssertionError(
                    f"nodekern {name}: cycle {eng.cycle} against the general "
                    f"engine's {int(got['cycle'].max())}")
            err_all = max(err_all, err)
            row.update(general_max_abs_err=err, general_ms=grec["ms"])
            print(f"[nodekern] {name}: dumps, snapshots, per-system counters "
                  f"and cycle ({eng.cycle}) equal the general engine's "
                  f"(build_batched_run) on the same arrays: max_abs_err={err}")
        rec["runs"][name] = row
        print(f"[nodekern] {name} ({cfg.num_procs} nodes x {eng.b} systems x "
              f"{arrays[0].shape[2]} instructions, 4 logical ranks on "
              f"cuda:0, {eng.cycles_per_call} cycles a call, the first "
              f"checked): {eng.cycle} cycles, every instruction retired; "
              f"rank 0's launches {row['node_launches_rank0']}")
    for k, (c, x) in checked.items():
        if c == 0 or x:
            raise AssertionError(f"nodekern: {k} checked {c}, err {x}")
    rec["checked"] = checked
    rec["max_abs_err"] = err_all
    print(f"[nodekern] wide family: every launch of each run's first call "
          f"held against its plain version on the same inputs: {checked} "
          "(launches checked, max_abs_err)")
    # each wide kernel and its plain version on the 4,096-node run's kept
    # cycle
    name = NODEKERN_WIDE_RUNS[-1][0]
    job = _NodeJob(_nodekern_time_rank, engs[name][2], k=4,
                   keep_at=NODEKERN_WIDE_KEEP_AT, reps=NODEKERN_WIDE_REPS)
    run_node_sharded([job])
    times = next(r["times"] for r in job.rows if r["times"])
    rec["times"] = {}
    for k, tm in times.items():
        bound = tm["bytes"] / HBM_BYTES_PER_S * 1e3
        grid = tm["grid"]
        rec["times"][k] = dict(
            ms=round(tm["ms"], 4), wrapper_ms=round(tm["wrapper_ms"], 4),
            plain_ms=round(tm["plain_ms"], 4), bound_ms=round(bound, 6),
            bytes=tm["bytes"], grid=grid, empty_ms=round(tm["empty_ms"], 4))
        print(f"[nodekern] {k}: {tm['ms']:.4f} ms a launch (CUDA events "
              f"around the entry's launches alone, median of "
              f"{NODEKERN_WIDE_REPS}, 4,096 nodes x 8 over 4 ranks, cycle "
              f"{NODEKERN_WIDE_KEEP_AT} of a 4-cycle call's inputs; the "
              f"whole wrapper "
              f"{tm['wrapper_ms']:.4f}), plain version {tm['plain_ms']:.4f} "
              f"ms, bound {bound:.6f} ms ({tm['bytes']} B over 3.35 TB/s); "
              f"main launch's grid {grid['ctas']} CTAs of {grid['threads']} "
              f"threads ({grid['lanes']} pairs (N1w) or lanes (N2w) a CTA, "
              f"{grid['smem']} B shared each, {grid['ctas_per_sm']} an SM at "
              f"once) on {grid['sms_covered']} of {grid['sms']} SMs; an "
              f"empty launch of that grid {tm['empty_ms']:.4f} ms)")
    return rec


def node_ptxas():
    """Registers, stack frame and spill bytes (stores, loads) of every
    instantiation of each node kernel, from ptxas's census of the node
    library's build: kernel -> "bound int32|packed" -> row."""
    import re

    from hpa2_tpu_torch.analysis.ir import ptxas_census
    from hpa2_tpu_torch.ops import kernels, node_cycle

    out = {e.name: {} for e in node_cycle.ALL_NODE_KERNELS}
    wide = {e.name for e in node_cycle.WIDE_KERNELS}
    for row in ptxas_census(kernels.NODE_CYCLE.build_log):
        for name in out:
            # a wide entry's launches: node_<stage>_wide[_<launch>]_kernel
            m = re.search(name + (r"(?:_([a-z]+))?_kernel" if name in wide
                                  else r"_kernel(?:ILi(\d+)ELb([01])E)?"),
                          row["name"])
            if not m:
                continue
            if name in wide:
                inst = m.group(1) or "all"
            else:
                inst = ("all" if m.group(1) is None else
                        f"{m.group(1)} {'packed' if m.group(2) == '1' else 'int32'}")
            out[name][inst] = {f: row[f] for f in (
                "registers", "stack", "spill_stores", "spill_loads")}
    return out


def wide_entries(nodekern):
    """The kernels line's entries of the wide family: launches, checked
    launches and max_abs_err on ``[nodekern]``'s wide runs (logical ranks
    on one card), its timings and bounds at 4,096 nodes."""
    from hpa2_tpu_torch.ops import node_cycle

    wide = nodekern["wide"]
    out = []
    for kern in node_cycle.WIDE_KERNELS:
        t = wide["times"][kern.name]
        c, x = wide["checked"][kern.name]
        out.append({
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces,
            "launches": wide["launches"][kern.name],
            "checked_launches": c,
            "max_abs_err": max(x, wide["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "wrapper_ms": t["wrapper_ms"],
            "grid": t["grid"], "empty_launch_ms": t["empty_ms"],
            "ptxas": nodekern["ptxas"][kern.name],
            "by_path": {"nodekern wide logical ranks": {
                "launches": wide["launches"][kern.name],
                "checked_launches": c, "max_abs_err": x,
                "general_engine_max_abs_err": wide["max_abs_err"]}}})
    return out


def node_entries(nodekern, nodeshard):
    """The kernels line's entries of N1-N4: launches, checked launches
    and max_abs_err on ``[nodekern]``'s runs (the main path: logical
    ranks on one card), its timings and bounds, and ``[nodeshard]``'s
    NCCL runs under ``by_path`` where they ran."""
    from hpa2_tpu_torch.ops import node_cycle

    out = []
    for kern in node_cycle.NODE_KERNELS:
        t = nodekern["times"][kern.name]
        c, x = nodekern["checked"][kern.name]
        by_path = {"nodekern logical ranks": {
            "launches": nodekern["launches"][kern.name],
            "checked_launches": c, "max_abs_err": x,
            "planes_max_abs_err": nodekern["max_abs_err"]}}
        if "node_launches" in nodeshard:
            nc, nx = nodeshard["checked"][kern.name]
            by_path["nodeshard nccl ranks"] = {
                "launches": nodeshard["node_launches"][kern.name],
                "checked_launches": nc, "max_abs_err": nx}
        out.append({
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces,
            "launches": nodekern["launches"][kern.name],
            "checked_launches": c,
            "max_abs_err": max([x, nodekern["max_abs_err"]] + [
                p["max_abs_err"] for p in by_path.values()]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "by_path": by_path,
            "wrapper_ms": t["wrapper_ms"], "grid": t["grid"],
            "empty_launch_ms": t["empty_ms"],
            "ptxas": nodekern["ptxas"][kern.name],
            "at_4_ranks": {f: nodekern["times_4_ranks"][kern.name][f]
                           for f in ("ms", "wrapper_ms", "plain_ms",
                                     "bound_ms", "grid", "empty_ms")}})
    return out


#: the phases ``--only`` may name (a debugging aid: those phases alone,
#: after the build, and no kernels line); with no arguments every phase
#: runs
ONLY = ("compare", "serve", "general-scheduled", "serve-jax", "recovery",
        "entry", "analysis", "ablate", "scale", "shard", "nodeshard",
        "nodekern")


def main(argv=None) -> int:
    try:
        return smoke(sys.argv[1:] if argv is None else argv)
    finally:
        for pool in HOST_POOL:
            pool.shutdown(cancel_futures=True)


def smoke(argv) -> int:
    """The build, then every phase (or those ``--only`` names)."""
    only = None
    if argv:
        if len(argv) != 2 or argv[0] != "--only" or not set(
                argv[1].split(",")) <= set(ONLY):
            print(f"usage: chip_smoke.py [--only {','.join(ONLY)}]",
                  file=sys.stderr)
            return 2
        only = argv[1].split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from hpa2_tpu_torch.analysis import vmem
    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.ops import kernels

    card = card_line()
    print(card)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernels.build_all()
    secs = time.perf_counter() - t0
    names = ", ".join(k.library_path().name for k in kernels.LIBRARIES)
    print(f"[build] {secs:.1f} s, all compilers at once: {names}")
    # registers, stack frame and spills of each instantiation
    for kern in kernels.LIBRARIES:
        for line in kern.build_log.splitlines():
            if any(w in line for w in ("Compiling entry",
                                       "Function properties", "registers",
                                       "spill")):
                print(f"[build] {kern.name}: {line.strip()}")
    # shared memory and occupancy of each instantiation at the main
    # paths' lane block (512), at 1024, and at the card's largest block
    # of the node bound (kernels.MAX_LANE_BLOCK: 16 CTAs, most rounds),
    # each held against the Hopper budget model (analysis/vmem.py)
    budget_rows = 0
    for n, base in ((8, 32768), (12, 1024), (64, 1024)):
        cfg = SystemConfig(num_procs=n, msg_buffer_size=16)
        most = kernels.MAX_LANE_BLOCK[kernels.node_bound(cfg)]
        for packed in (False, True):
            for block, lanes in ((512, base), (1024, base), (most, most)):
                for kern in kernels.KERNELS:
                    occ = kern.occupancy(
                        kernels.geometry_args(cfg, lanes=lanes, block=block,
                                              packed=packed),
                        device=torch.device("cuda"))
                    print(f"[build] {kern.name} node bound "
                          f"{8 if n <= 8 else 21 if n <= 21 else 64} packed "
                          f"{packed} block {block}: {occ['threads']} threads"
                          f" and {occ['smem']} B dynamic shared memory a "
                          f"CTA, {occ['ctas_per_sm']} CTAs an SM, "
                          f"{occ['clusters']} clusters of "
                          f"{occ['cl']} CTAs at once")
                    model = vmem.vmem_budget(cfg, block, 32, packed=packed)
                    if (model.smem_bytes, model.cta_threads, model.cl) != (
                            occ["smem"], occ["threads"], occ["cl"]):
                        raise AssertionError(
                            f"Hopper budget: model {model.smem_bytes} B, "
                            f"{model.cta_threads} threads, {model.cl} CTAs;"
                            f" card {occ}")
                    budget_rows += 1
                    print(f"[build] the Hopper budget model: "
                          f"{model.smem_bytes} B, {model.cta_threads} "
                          f"threads, {model.cl} CTAs (equal), "
                          f"{model.ctas_per_sm} CTAs an SM by threads and "
                          "shared memory")

    robust = Semantics().robust()
    wall = {}
    if only:
        def compare(card):
            for phase in (phase_compare, phase_wide_compare,
                          phase_call_compare, phase_team_compare,
                          settle_compare):
                phase()

        for name, phase in (("compare", compare), ("serve", phase_serve),
                            ("general-scheduled", phase_general_scheduled),
                            ("serve-jax", phase_serve_jax),
                            ("recovery", phase_recovery),
                            ("entry", phase_entry),
                            ("analysis", lambda card: phase_analysis(
                                budget_rows)),
                            ("ablate", lambda card: phase_ablate()),
                            ("scale", phase_scale),
                            ("shard", lambda card: phase_shard()),
                            ("nodeshard", lambda card: phase_nodeshard()),
                            ("nodekern", lambda card: phase_nodekern())):
            if name in only:
                t0 = time.perf_counter()
                phase(card)
                wall[name] = time.perf_counter() - t0
        print(f"[wall] host {host_cpu()}: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in wall.items()))
        return 0
    # the compare cases' kernel runs first: their plain versions then
    # run in the host pool while the card works through the next phases
    t0 = time.perf_counter()
    err = phase_compare()
    err = max(err, phase_wide_compare())
    call_err = phase_call_compare()
    err = max(err, phase_team_compare())
    wall["compare a-j, kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    micro = phase_micro()
    wall["micro-kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ablated = phase_ablate()
    wall["ablate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scale = phase_scale(card)
    wall["scale"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    settled = settle_compare()
    err = max(err, settled["stream_run"])
    call_err = max(call_err, settled["call_run"])
    wall["compare a-j, plain versions"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    headline_cfg = SystemConfig(semantics=robust, **HEADLINE)
    wide_cfg = SystemConfig(semantics=robust, **WIDE)
    paths = {
        "headline": drive_path("headline", headline_cfg, 32768, 128,
                               HEADLINE_RUN, probe=(128, 256, 1024)),
        "wide": drive_path("wide", wide_cfg, 1024, WIDE_INSTRS, WIDE_RUN,
                           probe=(64, 128, 256)),
    }
    paths["wide packed"] = drive_path(
        "wide packed", wide_cfg, 1024, WIDE_INSTRS, WIDE_RUN, packed=True,
        ref=paths["wide"]["state"])
    wall["streamed paths"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    call_paths = {
        "headline": drive_per_call_path(
            "per-call headline", headline_cfg, 32768, 128, HEADLINE_RUN,
            paths["headline"]["state"]),
        "wide": drive_per_call_path(
            "per-call wide", wide_cfg, 1024, WIDE_INSTRS, WIDE_RUN,
            paths["wide"]["state"], plain=False),
    }
    wall["per-call paths"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    shard_k2, shard_k3 = phase_shard(paths["headline"]["state"])
    wall["shard"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nodeshard = phase_nodeshard()
    wall["nodeshard"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nodekern = phase_nodekern()
    wall["nodekern"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scheduled = phase_scheduled()
    wall["scheduled"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    session = phase_session()
    wall["session"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = phase_serve(card)
    wall["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    general = phase_general(card)
    wall["general"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scheduled_general = phase_general_scheduled(card)
    wall["general scheduled"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    served_jax = phase_serve_jax(card)
    wall["serve jax"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    recovery = phase_recovery(card)
    wall["recovery"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_run_command()
    wall["run and bench commands"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    entry_paths = phase_entry(card, paths["headline"]["state"])
    wall["entry"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    analysis = phase_analysis(budget_rows)
    wall["analysis"] = time.perf_counter() - t0
    print(f"[wall] host {host_cpu()}: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in wall.items()))

    keys = ("launches", "ms", "plain_ms", "bound_ms", "bound_by")

    def entry(kern, main, by_path, err, variants):
        return {
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "variants": variants,
            "launches": main["launches"][kern.name],
            "max_abs_err": max([err] + [p["err"] for p in by_path.values()]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "by_path": {name: {k: p[k] for k in keys + ("held_to",)
                               if k in p}
                        for name, p in by_path.items()},
        }

    variants = ["unsplit (num_procs <= 21)",
                "split sharer planes (22 <= num_procs <= 64)",
                "packed u8/u16 planes"]
    stream_entry = entry(kernels.STREAM_RUN, paths["wide"], paths, err,
                         variants)
    call_entry = entry(kernels.CALL_RUN, call_paths["headline"], call_paths,
                       call_err, variants)
    # the scheduled runs and the session: launches of the counted run,
    # and the largest difference of the checked run's launches from the
    # plain version
    for name, run in scheduled.items():
        if name == "host":
            continue
        for kern_entry in (stream_entry, call_entry):
            n = run["launches"][kern_entry["name"]]
            if n:
                path = {"launches": n, "engine_ms": run["ms"]}
                if "err" in run:
                    path.update(checked_launches=run["checked"],
                                max_abs_err=run["err"])
                else:
                    path["held_to"] = ("the checked unscheduled and "
                                       "resident 8192 fused runs' planes")
                kern_entry["by_path"][f"scheduled {name}"] = path
    for stream, run in session.items():
        kern_entry = stream_entry if stream else call_entry
        kern_entry["by_path"]["session"] = {
            "launches": run["launches"][kern_entry["name"]],
            "checked_launches": run["checked"], "max_abs_err": run["err"]}
    stream_entry["by_path"]["serve"] = {
        "launches": served["launches"]["stream_run"],
        "checked_launches": served["checked"], "max_abs_err": served["err"],
        **{k: served[k] for k in ("ms", "bound_ms", "bound_by", "wall_ms")}}
    # the general engine has no kernel of its own: K2 runs beside it as
    # its cross-check at MESI/full/ideal
    stream_entry["by_path"]["general cross-check"] = {
        "launches": general["k2_launches"], "max_abs_err": general["err"],
        "k2_ms": general["k2"],
        "general_ms": {"headline elision on": general["head"]["ms"],
                       "headline elision off": general["head_off"]["ms"],
                       "64 nodes": general["wide"]["ms"]}}
    # the general engine's serving backend against the fast path, and
    # the recovery supervisor's primary (K2 under CudaLaneSession)
    stream_entry["by_path"]["serve jax cross-check"] = {
        "launches": served_jax["launches"],
        "checked_launches": served_jax["checked"],
        "max_abs_err": served_jax["err"]}
    stream_entry["by_path"]["recovery primary"] = {
        "launches": recovery["launches"],
        "checked_launches": recovery["checked"],
        "max_abs_err": recovery["err"]}
    # the entry points: the bench harness, the CLI's workloads, backends
    # and quirks, the studies
    for name, path in entry_paths.items():
        stream_entry["by_path"][f"entry {name}"] = path
    # the analysis suite's table prober: one cycle of K3, every probeable
    # row a lane
    call_entry["by_path"]["analysis prober"] = analysis
    # BASELINE.json's configuration 5 at full size (scale_runs.py)
    stream_entry["by_path"]["scale config5"] = scale
    # the data axis over the cards: one launch a shard
    stream_entry["by_path"].update(shard_k2)
    call_entry["by_path"].update(shard_k3)
    for kern_entry in (stream_entry, call_entry):
        kern_entry["max_abs_err"] = max(
            [kern_entry["max_abs_err"]]
            + [p.get("max_abs_err", 0)
               for p in kern_entry["by_path"].values()])
    print(json.dumps({"kernels": [stream_entry, call_entry,
                                  micro_entry(kernels.MICRO, micro)]
                      + ablated + node_entries(nodekern, nodeshard)
                      + wide_entries(nodekern)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
