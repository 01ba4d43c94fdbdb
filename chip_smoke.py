#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds both CUDA kernels from ``hpa2_tpu_torch/csrc`` with nvcc, the two
compilers at once (the streamed run ``stream_run.cu`` and the per-call
kernel ``call_run.cu``, each for node bounds 8, 21 and 64), holds each
bit for bit against its plain PyTorch version on the card (streamed
run: cases a-e at up to 8 nodes, f: split sharer planes at 22, 33 and
64 nodes, g: packed planes; per-call kernel under its host loop:
case h at 4, 8, 22 and 33 nodes, ragged windows, gate on and off,
packed, and a stall), and drives through ``CudaEngine``:

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
* the ``run`` command on a small trace directory and the ``bench``
  command, unscheduled and scheduled,

and prints:

* the card's name and power limit (``nvidia-smi``);
* the host syncs of each path (``[syncs]``);
* one ``{"kernels": [...]}`` line: per kernel its launches on its main
  path (the 64-node streamed run; the headline per-call run), its
  largest disagreement with the plain version, its time and the plain
  version's at that shape, and its bytes bound (``by_path`` holds the
  same for every path driven);
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
#: 32-bit integer work of the cycle is held to it
SCALAR_OPS_PER_S = 67e12

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


def planes_for(cfg, b, t, seed, snapshots, window, packed=False):
    """Initial planes and packed traces on the card, from a seed."""
    from hpa2_tpu_torch.convert import state_from_numpy
    from hpa2_tpu_torch.ops.layout import _init_state, _pack_traces
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    op, addr, val, length = gen_uniform_random_arrays(cfg, b, t, seed=seed)
    n_seg = -(-t // window)
    tr = _pack_traces(cfg, op, addr, val, length)
    tr = np.pad(tr, ((0, 0), (0, n_seg * window - t), (0, 0)))
    state = state_from_numpy(_init_state(cfg, b, snapshots, packed), "cuda")
    return (state, torch.from_numpy(tr).cuda(),
            torch.from_numpy(np.ascontiguousarray(length.T)).cuda(), n_seg)


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
                    gate, max_calls, stall, reps=1, packed=False):
    """``reps`` kernel launches and one plain run from the same planes;
    every carried plane and the stall plane must agree bit for bit, and
    the stall must be as ``stall`` says (True, False, or None for
    either).  Returns (max abs difference, mean kernel ms, plain ms,
    kernel planes, stall plane)."""
    from hpa2_tpu_torch.ops.stream_run import stream_run_plain

    state, tr, tr_len, n_seg = planes_for(cfg, b, t, seed, snapshots, window,
                                          packed)
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


def phase_compare():
    """Cases (a)-(e): the kernel against its plain version at up to 8
    nodes."""
    from hpa2_tpu_torch.config import Semantics, SystemConfig

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
    # a loose floor on the work: one scalar op per node per active
    # system-cycle
    ops_ms = lane_cycles * cfg.num_procs / SCALAR_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[{label}] {b} systems x {cfg.num_procs} nodes x {t} instrs "
          f"(cache {cfg.cache_size}, mem {cfg.mem_size}, cap "
          f"{cfg.msg_buffer_size}, block {run['block']}, window "
          f"{run['window']}, k {run['k']}, packed {packed}): status 0, "
          f"{eng.instructions} RD/WR retired, {int(sc[_SC_MSGS].sum())} "
          f"messages, max cycle {eng.cycle}, {lane_cycles} system-cycles")
    print(f"[{label}] engine run {run_ms:.3f} ms "
          f"({eng.instructions / run_ms * 1e3:.4e} RD/WR ops/s), kernel "
          f"{ms:.3f} ms ({eng.instructions / ms * 1e3:.4e} RD/WR ops/s), "
          f"plain {plain_ms:.1f} ms, launches {launches}")
    print(f"[{label}] bytes bound: {moved} B (state {state_bytes} B read and "
          f"written, traces {trace_bytes} B) / 3.35 TB/s = {bytes_ms:.4f} "
          f"ms; ops floor {ops_ms:.4f} ms; CTAs {b // run['block']} on 132 "
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
                      window, gate, max_calls, stall, packed=False):
    """The per-call kernel under its host loop and the same loop over the
    plain version, from the same planes; every carried plane and the
    status word must agree, and the stall must be as ``stall`` says
    (True, False, or None for either)."""
    from hpa2_tpu_torch.ops.call_run import run_windows

    state, tr, tr_len, n_seg = planes_for(cfg, b, t, seed, snapshots, window,
                                          packed)
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


def drive_per_call_path(label, cfg, b, t, run, ref, packed=False):
    """The per-call path at full width: ``CudaEngine(stream=False).run()``
    with the counts read around it, then the kernel alone under its
    loop (each launch timed) and the plain version, all held against
    each other and against the streamed run's planes ``ref``; the bytes
    bound counts every call: state read and written once, the window's
    traces read once."""
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
    from hpa2_tpu_torch.ops.layout import _SC_CYCLE
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
    ops_ms = lane_cycles * n / SCALAR_OPS_PER_S * 1e3
    print(f"[{label}] {b} systems x {n} nodes x {t} instrs (block "
          f"{run['block']}, window {w}, k {run['k']}, packed {packed}, "
          f"stream=False): status 0, {eng.instructions} RD/WR retired, max "
          f"cycle {eng.cycle}, {lane_cycles} system-cycles; planes equal "
          "the streamed run's")
    rate = eng.instructions / run_ms * 1e3
    print(f"[{label}] engine run {run_ms:.3f} ms ({rate:.4e} RD/WR ops/s), "
          f"{launches['call_run']} launches, "
          f"{syncs} host syncs; kernel {res['ms']:.3f} ms summed over "
          f"launches; plain {res['plain_ms']:.1f} ms")
    print(f"[{label}] bytes bound: {res['launches']} calls x ({state_bytes} "
          f"B state read and written + {window_bytes} B window) = {moved} B "
          f"/ 3.35 TB/s = {bytes_ms:.4f} ms; ops floor {ops_ms:.4f} ms")
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
        for f in ("cachew", "dirw", "scalars", "msg_counts"):
            got = torch.cat([harvested[s][f] for s in range(b)], dim=-1)
            err = max(err, check_diff(
                f"session stream={stream} plane {f}",
                {f: int((got.long() - one_shot.state[f].long()).abs().max())}))
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
        rc = cli.main(["run", str(traces), "--robust", "--out", str(out),
                       "--device", dev])
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
        rc = cli.main(["bench", "--batch", str(batch), "--instrs",
                       str(instrs), "--nodes", "8", "--msg-buffer-size", "16",
                       "--robust", "--seed", "0"])
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
        rc = cli.main(["bench", "--batch", str(batch), "--instrs",
                       str(instrs), "--nodes", "8", "--msg-buffer-size", "16",
                       "--robust", "--seed", "0", "--block", "512",
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
    names = ", ".join(k.library_path().name for k in kernels.KERNELS)
    print(f"[build] {secs:.1f} s, both compilers at once: {names}")
    # registers, stack frame and spills of each instantiation
    for kern in kernels.KERNELS:
        for line in kern.build_log.splitlines():
            if any(w in line for w in ("Compiling entry",
                                       "Function properties", "registers",
                                       "spill")):
                print(f"[build] {kern.name}: {line.strip()}")

    robust = Semantics().robust()
    wall = {}
    t0 = time.perf_counter()
    err = phase_compare()
    err = max(err, phase_wide_compare())
    call_err = phase_call_compare()
    wall["compare a-h"] = time.perf_counter() - t0
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
    for kern_entry in (stream_entry, call_entry):
        kern_entry["max_abs_err"] = max(
            [kern_entry["max_abs_err"]]
            + [p.get("max_abs_err", 0)
               for p in kern_entry["by_path"].values()])
    print(json.dumps({"kernels": [stream_entry, call_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
