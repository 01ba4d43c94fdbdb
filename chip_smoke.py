#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the three CUDA libraries from ``hpa2_tpu_torch/csrc`` with nvcc,
the compilers at once (the streamed run ``stream_run.cu`` and the
per-call kernel ``call_run.cu``, each for node bounds 8, 21 and 64, and
the op-pattern micro-kernels ``micro_kernels.cu``), runs the
micro-kernels' runner (``hpa2_tpu_torch.scripts.micro_kernels``: its
``main()`` at 8,192 lanes and its ``bench`` at 32,768) and holds each
pattern's kernel bit for bit against its plain version at both sizes,
holds the fast path's kernels bit for bit against their plain PyTorch
versions on the card (streamed run: cases a-e at up to 8 nodes, f:
split sharer planes at 22, 33 and 64 nodes, g: packed planes; per-call
kernel under its host loop: case h at 4, 8, 22 and 33 nodes, ragged
windows, gate on and off, packed, and a stall; both kernels: case i, a
lane block over several CTAs with one CTA idle from the start and
snapshots on, and case j, a stalled block over two CTAs; case k, lane
blocks above 1,024 lanes, up to the card's largest at the 8-node
bound), and drives through ``CudaEngine``:

* the streamed fast path at the repo's headline width (32,768 systems
  x 8 nodes x 128 instructions per core) and at its 64-node
  single-chip width (1,024 systems x 64 nodes x 64 instructions,
  unpacked and packed; ``scripts/scale_runs.py``'s single-device
  rung);
* the per-call path (``stream=False``) at the same two widths, held
  against the streamed run's planes;
* the occupancy scheduler on ``bench.py --trace-len-dist zipf``'s
  workload at the headline shape: unscheduled, fused, fused with 8,192
  resident lanes, the same with host barriers, and with the per-call
  kernel inside; each first in a run whose every launch is held
  against the plain version on its own planes and windows;
* a resident-lane session (``CudaLaneSession``), its launches held
  against the plain version, and its results against the one-shot
  run;
* always-on serving (``hpa2_tpu_torch.serving.serve``) at
  ``bench.py``'s accelerator geometry (16,384 zipf jobs through 4,096
  resident lanes, window 32, block 512): a checked pass at a smaller
  feed whose every launch is held against the plain version, then the
  pipelined run, the serial run, a Poisson-arrival run, a framed-wire
  run with two clients and the ``serve`` command, every served job's
  dumps equal to the one-shot scheduled run's;
* the general engine (``hpa2_tpu_torch.ops.engine``, ``[general]``), at
  ``bench.py``'s headline configuration: 4,096 systems x 8 nodes x 128
  instructions, elision on and off, held against K2 on the same arrays
  (dumps, snapshots, counters, cycle) and against the CPU on 64
  systems; MOESI, MESIF, ``limited:2``, ``coarse:4``, ``mesh2d`` with
  multicast, ``torus2d`` with combining, ``hierarchical`` and
  ``bench.py``'s fault mix at 1,024 systems each, held against the CPU
  on 32 systems in every state field; the 64-node configuration at 256
  systems against K2; a severed edge whose ``StallDiagnostic`` must
  equal the CPU's; and ``run``/``bench --backend jax`` (the CPU
  references run in four spawned worker processes meanwhile);
* the ``run`` command on a small trace directory and the ``bench``
  command on the fast path (``--backend pallas``), unscheduled and
  scheduled,

and prints:

* the card's name and power limit (``nvidia-smi``);
* per kernel instantiation, ptxas's registers, stack frame and spills,
  and the shared memory, CTAs an SM and clusters the card holds at
  once at lane blocks of 512 and 1,024 (``[build]``);
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
  micro-kernels' runner; the pipelined serving run, and K2's
  cross-checks beside the general engine, under ``by_path``), its
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
WIDE = dict(num_procs=64, msg_buffer_size=16, max_instr_num=0)
WIDE_RUN = dict(block=512, k=64, window=16, gate=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def planes_for(cfg, b, t, seed, snapshots, window, packed=False, idle=0,
               block=1):
    """Initial planes and packed traces on the card, from a seed; the
    first ``idle`` lanes of each ``block`` get empty traces."""
    from hpa2_tpu_torch.convert import state_from_numpy
    from hpa2_tpu_torch.ops.layout import _init_state, _pack_traces
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    op, addr, val, length = gen_uniform_random_arrays(cfg, b, t, seed=seed)
    length.reshape(b // block, block, -1)[:, :idle] = 0
    n_seg = -(-t // window)
    tr = _pack_traces(cfg, op, addr, val, length)
    tr = np.pad(tr, ((0, 0), (0, n_seg * window - t), (0, 0)))
    state = state_from_numpy(_init_state(cfg, b, snapshots, packed), "cuda")
    return (state, torch.from_numpy(tr).cuda(),
            torch.from_numpy(np.ascontiguousarray(length.T)).cuda(), n_seg)


def cycle_ops(n, system_cycles, messages, instructions):
    """Integer operations a run needs (see ``OPS_NODE_CYCLE``): every
    node's checks in every system-cycle with work, every message handled
    and delivered, every RD/WR issued; from the run's own counters."""
    return (system_cycles * n * OPS_NODE_CYCLE + messages * OPS_MESSAGE
            + instructions * OPS_ISSUE)


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
                    gate, max_calls, stall, reps=1, packed=False, idle=0):
    """``reps`` kernel launches and one plain run from the same planes
    (the first ``idle`` lanes of each block without work); every carried
    plane and the stall plane must agree bit for bit, and the stall must
    be as ``stall`` says (True, False, or None for either).  Returns
    (max abs difference, mean kernel ms, plain ms, kernel planes, stall
    plane)."""
    from hpa2_tpu_torch.ops.stream_run import stream_run_plain

    state, tr, tr_len, n_seg = planes_for(cfg, b, t, seed, snapshots, window,
                                          packed, idle, block)
    kw = dict(block=block, k=k, window=window, n_seg=n_seg,
              max_calls=max_calls, gate=gate, snapshots=snapshots,
              packed=packed)
    times, got, status = time_kernel(cfg, state, tr, tr_len, kw, reps)
    ms = sum(times) / reps
    if stall is not None and bool(status.any()) != stall:
        raise AssertionError(
            f"{label}: the kernel {'did not stall' if stall else 'stalled'}")
    (want, want_status), plain_ms = elapsed_ms(
        lambda: stream_run_plain(cfg, state, tr, tr_len, **kw))
    diff = plane_diff(cfg, snapshots, got, want, packed)
    diff["status"] = int((status.long() - want_status.long()).abs().max())
    err = max(diff.values())
    stalled = int(status.any())
    print(f"[compare] {label}: {b} systems x {cfg.num_procs} nodes x {t} "
          f"instrs, cache {cfg.cache_size}, mem {cfg.mem_size}, cap "
          f"{cfg.msg_buffer_size}, block {block}, window {window}, gate "
          f"{gate}, snapshots {snapshots}, packed {packed}: stalled="
          f"{stalled} max_abs_err={err} kernel {ms:.3f} ms "
          f"({', '.join(f'{x:.3f}' for x in times)}), plain {plain_ms:.1f} ms")
    check_diff(label, diff)
    return err, ms, plain_ms, got, status


@contextlib.contextmanager
def checked_kernels(label):
    """Hold every kernel launch made inside against the plain version:
    ``kernels.stream_run`` and ``kernels.call_run`` are wrapped so that
    each keeps a copy of the planes it is given, launches the kernel as
    usual, runs the plain version on the copy with the same trace
    planes and arguments, and compares every carried plane (and the
    streamed run's stall plane) bit for bit.  The launches are the
    code's own, so the launch counts are unchanged; the time is not.
    Yields the record: checks per kernel, lanes checked with an empty
    window (idle lanes, ``tr_len`` 0 on every node) and with a window
    that ends early on some node, and the largest difference."""
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.call_run import call_plain, window_planes
    from hpa2_tpu_torch.ops.stream_run import stream_run_plain

    rec = {"stream_run": 0, "call_run": 0, "idle_lanes": 0,
           "ragged_lanes": 0, "err": 0, "seconds": 0.0}
    launch = {"stream_run": kernels.stream_run,
              "call_run": kernels.call_run}

    def coverage(tl, window):
        rec["idle_lanes"] += int((tl == 0).all(0).sum())
        rec["ragged_lanes"] += int((tl % window != 0).any(0).sum())

    def compare(name, config, kw, got, want, extra=None):
        diff = plane_diff(config, kw["snapshots"], got, want,
                          kw.get("packed", False))
        diff.update(extra or {})
        rec["err"] = max(rec["err"], check_diff(f"{label} {name}", diff))
        rec[name] += 1

    def stream_run(config, state, tr, tr_len, **kw):
        before = {f: v.clone() for f, v in state.items()}
        status = launch["stream_run"](config, state, tr, tr_len, **kw)
        t0 = time.perf_counter()
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
                                stall=False, **HEADLINE_RUN)[0])
    # (b) the `run` command's geometry (4 nodes, cap 256), snapshots on
    cfg = SystemConfig(semantics=robust)
    errs.append(kernel_vs_plain("b run-default", cfg, 256, 32, 2,
                                snapshots=True, block=256, k=128,
                                window=32, gate=True, max_calls=10_000,
                                stall=False)[0])
    # (c) fixture ("drop") semantics: random traffic livelocks, so the
    # stall bit must agree
    cfg = SystemConfig(msg_buffer_size=16)
    errs.append(kernel_vs_plain("c drop", cfg, 256, 24, 3, snapshots=True,
                                block=64, k=32, window=24, gate=True,
                                max_calls=8, stall=True)[0])
    # (d) tiny mailboxes: deferred sends and backpressure.  At 8 nodes
    # and 4 slots some random systems deadlock on full mailboxes, so the
    # call budget is short and those blocks report the stall.
    cfg = SystemConfig(num_procs=8, msg_buffer_size=4, semantics=robust)
    errs.append(kernel_vs_plain("d cap4", cfg, 256, 32, 4, snapshots=False,
                                block=32, k=128, window=32, gate=True,
                                max_calls=8, stall=None)[0])
    # (e) no quiescence gate
    cfg = SystemConfig(semantics=robust, **HEADLINE)
    errs.append(kernel_vs_plain("e gate-off", cfg, 1024, 64, 5,
                                snapshots=False, block=256, k=128,
                                window=32, gate=False, max_calls=10_000,
                                stall=False)[0])
    # (k) lane blocks above 1,024 at the headline geometry: 2,048 (a
    # cluster of 8 CTAs, the first idle from the start) and the card's
    # largest at the 8-node bound (16 CTAs of 5 rounds)
    errs.append(kernel_vs_plain("k block 2048", cfg, 6144, 32, 6,
                                snapshots=False, block=2048, k=128,
                                window=32, gate=True, max_calls=10_000,
                                stall=False, idle=256)[0])
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
                                gate=True, max_calls=10_000, stall=False)[0])
    cfg33 = SystemConfig(num_procs=33, cache_size=4, mem_size=8,
                         msg_buffer_size=32, semantics=robust)
    errs.append(kernel_vs_plain("f 33 nodes", cfg33, 256, 20, 12,
                                snapshots=False, block=128, k=64, window=10,
                                gate=True, max_calls=10_000, stall=False)[0])
    cfg64 = SystemConfig(semantics=robust, **WIDE)
    errs.append(kernel_vs_plain("f 64 nodes", cfg64, 512, 16, 13,
                                snapshots=False, block=256, k=64, window=16,
                                gate=True, max_calls=10_000, stall=False)[0])

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
        max_calls=10_000, stall=False, packed=True, **kw22)
    errs.append(err)
    errs.append(packed_vs_unpacked("g packed 22 nodes", cfg22, 256, 12, 14,
                                   True, kw22, got))
    return max(errs)


def drive_path(label, cfg, b, t, run, *, packed=False, ref=None,
               probe=()):
    """One path of the port at full width: ``CudaEngine.run()`` with the
    launch counts read around it, then the kernel alone (mean of 3
    launches) on the same inputs, held against the plain version (and,
    packed, against the unpacked kernel's planes ``ref``), the bytes
    bound and a lane-block probe (one launch per block size)."""
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
    err, ms, plain_ms, got, _ = kernel_vs_plain(
        label, cfg, b, t, 0, snapshots=False, max_calls=10_000, stall=False,
        reps=3, packed=packed, **run)
    if ref is not None:
        err = max(err, check_diff(label, joined_diff(cfg, False, got, ref)))
        print(f"[compare] {label}: against the unpacked kernel, planes "
              f"joined: max_abs_err={err}")
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
          f"plain {plain_ms:.1f} ms, launches {launches}")
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
    return dict(launches=launches, err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                state=got)


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
                      window, gate, max_calls, stall, packed=False, idle=0):
    """The per-call kernel under its host loop and the same loop over the
    plain version, from the same planes (the first ``idle`` lanes of
    each block without work); every carried plane and the status word
    must agree, and the stall must be as ``stall`` says (True, False, or
    None for either)."""
    from hpa2_tpu_torch.ops.call_run import run_windows

    state, tr, tr_len, n_seg = planes_for(cfg, b, t, seed, snapshots, window,
                                          packed, idle, block)
    kw = dict(block=block, k=k, window=window, n_seg=n_seg,
              max_calls=max_calls, gate=gate, snapshots=snapshots,
              packed=packed)
    times, got, status, reads = per_call_kernel(cfg, state, tr, tr_len, kw)
    if stall is not None and bool(status & 1) != stall:
        raise AssertionError(
            f"{label}: the kernel {'did not stall' if stall else 'stalled'}")
    want = {f: v.clone() for f, v in state.items()}
    want_status, plain_ms = elapsed_ms(lambda: int(run_windows(
        cfg, want, tr, tr_len, call=plain_call, **kw)))
    diff = plane_diff(cfg, snapshots, got, want, packed)
    diff["status"] = abs(status - want_status)
    err = max(diff.values())
    print(f"[compare] {label}: {b} systems x {cfg.num_procs} nodes x {t} "
          f"instrs, cache {cfg.cache_size}, mem {cfg.mem_size}, cap "
          f"{cfg.msg_buffer_size}, block {block}, window {window}, k {k}, "
          f"gate {gate}, snapshots {snapshots}, packed {packed}: status "
          f"{status}, {len(times)} launches, {reads} host reads, "
          f"max_abs_err={err} kernel {sum(times):.3f} ms summed over "
          f"launches, plain {plain_ms:.1f} ms")
    check_diff(label, diff)
    return dict(err=err, ms=sum(times), plain_ms=plain_ms,
                launches=len(times), state=got, status=status, reads=reads)


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
            stall=False)["err"])
    cfg8 = SystemConfig(semantics=robust, **HEADLINE)
    for w, t, gate in ((7, 20, False), (8, 40, True), (1, 6, True)):
        errs.append(per_call_vs_plain(
            f"h 8 nodes window {w}/{t}", cfg8, 1024, t, 22 + w,
            snapshots=False, block=256, k=32, window=w, gate=gate,
            max_calls=10_000, stall=False)["err"])
    cfg22 = SystemConfig(num_procs=22, cache_size=2, mem_size=4,
                         msg_buffer_size=16, semantics=robust)
    errs.append(per_call_vs_plain(
        "h 22 nodes", cfg22, 256, 12, 23, snapshots=True, block=64, k=32,
        window=12, gate=True, max_calls=10_000, stall=False)["err"])
    cfg33 = SystemConfig(num_procs=33, cache_size=4, mem_size=8,
                         msg_buffer_size=32, semantics=robust)
    errs.append(per_call_vs_plain(
        "h 33 nodes", cfg33, 256, 20, 24, snapshots=False, block=128, k=64,
        window=10, gate=False, max_calls=10_000, stall=False)["err"])
    errs.append(per_call_vs_plain(
        "h packed 8 nodes", cfg8, 2048, 64, 25, snapshots=False,
        max_calls=10_000, stall=False, packed=True, **HEADLINE_RUN)["err"])
    errs.append(per_call_vs_plain(
        "h packed 22 nodes", cfg22, 256, 12, 26, snapshots=True, block=64,
        k=32, window=12, gate=True, max_calls=10_000, stall=False,
        packed=True)["err"])
    # 8 nodes, 4 mailbox slots: some systems deadlock, so the budget is
    # short and the stall status must agree
    cfg_cap4 = SystemConfig(num_procs=8, msg_buffer_size=4, semantics=robust)
    errs.append(per_call_vs_plain(
        "h cap4", cfg_cap4, 256, 32, 4, snapshots=False, block=32, k=128,
        window=32, gate=True, max_calls=8, stall=None)["err"])
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
            f"{label} ({cl} CTAs a block)", cfg, 2048, 30, 31,
            snapshots=True, block=block, k=32, window=12, gate=True,
            max_calls=10_000, stall=False, idle=per_cta)
        idle = got["snap_taken"].reshape(cfg.num_procs, -1, block)
        if not bool(idle[:, :, :per_cta].all()):
            raise AssertionError(f"{label}: idle systems took no snapshot")
        errs.append(err)
    cl, per_cta = geometry(cfg8, 512)
    errs.append(per_call_vs_plain(
        f"i idle CTA per-call 8 nodes ({cl} CTAs a block)", cfg8, 2048, 30,
        32, snapshots=True, block=512, k=32, window=12, gate=True,
        max_calls=10_000, stall=False, idle=per_cta)["err"])
    cl, per_cta = geometry(cap4, 512)
    errs.append(kernel_vs_plain(
        f"j stalled {cl} CTAs a block", cap4, 1024, 32, 33, snapshots=False,
        block=512, k=16, window=32, gate=True, max_calls=2, stall=True,
        idle=per_cta)[0])
    errs.append(per_call_vs_plain(
        f"j stalled per-call {cl} CTAs a block", cap4, 1024, 32, 34,
        snapshots=True, block=512, k=16, window=32, gate=True, max_calls=2,
        stall=True, idle=per_cta)["err"])
    return max(errs)


def drive_per_call_path(label, cfg, b, t, run, ref, packed=False):
    """The per-call path at full width: ``CudaEngine(stream=False).run()``
    with the counts read around it, then the kernel alone under its
    loop (each launch timed) and the plain version, all held against
    each other and against the streamed run's planes ``ref``; the bytes
    bound counts every call: state read and written once, the window's
    traces read once."""
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
                            **run)
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
          f"longest system); plain {res['plain_ms']:.1f} ms")
    print(f"[{label}] bound: bytes {res['launches']} calls x ({state_bytes} "
          f"B state read and written + {window_bytes} B window) = {moved} B "
          f"/ 3.35 TB/s = {bytes_ms:.4f} ms; operations {ops} / "
          f"{SCALAR_OPS_PER_S:.3g} ops/s = {ops_ms:.4f} ms; kernel / bound "
          f"{res['ms'] / max(bytes_ms, ops_ms):.1f}")
    print(f"[syncs] {label}: {syncs} host syncs in one run() "
          f"({res['reads']} quiescence reads of the per-call loop over "
          f"{launches['call_run']} calls, 1 status read)")
    return dict(launches=launches, err=err, ms=res["ms"],
                plain_ms=res["plain_ms"],
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                run_ms=run_ms, syncs=syncs)


#: bench.py --trace-len-dist zipf at its defaults, at the headline shape
ZIPF_BATCH, ZIPF_INSTRS, ZIPF_SPREAD, ZIPF_RESIDENT = 32768, 128, 8.0, 8192
#: the scheduled runs whose launches are each held against the plain
#: version: the unscheduled reference, and the resident runs with the
#: streamed and the per-call kernel inside (the other two must equal
#: these plane for plane)
CHECKED_SCHEDULED = ("unscheduled", "resident 8192 fused",
                     "resident 8192 per-call")


def phase_scheduled():
    """The occupancy scheduler at full width: five runs of the zipf
    workload.  The warm-ups of the runs in ``CHECKED_SCHEDULED`` hold
    every kernel launch against the plain version on the same planes
    and windows (the unscheduled run whole; the scheduled runs interval
    by interval, idle lanes and windows that end early included).  Then
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
#: :559-690, on ``_bench_config()``): 16,384 zipf-length jobs (spread 4,
#: seed 0) of up to 128 instructions a core through 4,096 resident lanes
SERVE = dict(resident=4096, window=32, block=512, policy="fcfs",
             backend="pallas")
SERVE_JOBS, SERVE_INSTRS = 16384, 128


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
    # of 26, so windows of 32 end early, and the feed's tail leaves lanes
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

    t_full = GENERAL_INSTRS
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
                                           GENERAL_INSTRS, seed=0)
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
                                           GENERAL_INSTRS, seed=0)
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
                       str(VARIANT_SYSTEMS), "--instrs", str(GENERAL_INSTRS),
                       "--nodes", "8", "--msg-buffer-size", "16", "--robust",
                       "--device", "cuda"])
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or rec["backend"] != "jax" or rec["device"] != "cuda" \
            or rec["instrs"] != VARIANT_SYSTEMS * 8 * GENERAL_INSTRS:
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

    arrays = gen_uniform_random_arrays(cfg, GENERAL_SYSTEMS, GENERAL_INSTRS,
                                       seed=0)
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


def phase_run_command():
    """``python -m hpa2_tpu_torch run`` on a synthesized trace
    directory, on the card and on the CPU (the dumps must be equal),
    and ``bench`` on the card (every instruction must retire)."""
    from hpa2_tpu_torch import cli
    from hpa2_tpu_torch.ops import kernels

    work = ROOT / "hpa2_tpu_torch" / "build" / "smoke_run"
    shutil.rmtree(work, ignore_errors=True)
    traces = work / "traces"
    traces.mkdir(parents=True)
    rng = np.random.default_rng(7)
    for core in range(4):
        lines = []
        for _ in range(24):
            a = int(rng.integers(0, 64))
            lines.append(f"WR 0x{a:02X} {int(rng.integers(0, 256))}"
                         if rng.random() < 0.5 else f"RD 0x{a:02X}")
        (traces / f"core_{core}.txt").write_text("\n".join(lines) + "\n")
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
    if rc != 0 or rec["backend"] != "cuda" \
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.ops import kernels

    card = card_line()
    print(card)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    secs = kernels.build_all()
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
    # of the node bound (kernels.MAX_LANE_BLOCK: 16 CTAs, most rounds)
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

    robust = Semantics().robust()
    wall = {}
    t0 = time.perf_counter()
    micro = phase_micro()
    wall["micro-kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    err = phase_compare()
    err = max(err, phase_wide_compare())
    call_err = phase_call_compare()
    err = max(err, phase_team_compare())
    wall["compare a-j"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    headline_cfg = SystemConfig(semantics=robust, **HEADLINE)
    wide_cfg = SystemConfig(semantics=robust, **WIDE)
    paths = {
        "headline": drive_path("headline", headline_cfg, 32768, 128,
                               HEADLINE_RUN, probe=(128, 256, 1024)),
        "wide": drive_path("wide", wide_cfg, 1024, 64, WIDE_RUN,
                           probe=(64, 128, 256)),
    }
    paths["wide packed"] = drive_path(
        "wide packed", wide_cfg, 1024, 64, WIDE_RUN, packed=True,
        ref=paths["wide"]["state"])
    wall["streamed paths"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    call_paths = {
        "headline": drive_per_call_path(
            "per-call headline", headline_cfg, 32768, 128, HEADLINE_RUN,
            paths["headline"]["state"]),
        "wide": drive_per_call_path(
            "per-call wide", wide_cfg, 1024, 64, WIDE_RUN,
            paths["wide"]["state"]),
    }
    wall["per-call paths"] = time.perf_counter() - t0
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
    phase_run_command()
    wall["run and bench commands"] = time.perf_counter() - t0
    print("[wall] " + ", ".join(f"{k} {v:.1f} s" for k, v in wall.items()))

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
            "by_path": {name: {k: p[k] for k in keys}
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
    for kern_entry in (stream_entry, call_entry):
        kern_entry["max_abs_err"] = max(
            [kern_entry["max_abs_err"]]
            + [p.get("max_abs_err", 0)
               for p in kern_entry["by_path"].values()])
    print(json.dumps({"kernels": [stream_entry, call_entry,
                                  micro_entry(kernels.MICRO, micro)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
