#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernel from ``hpa2_tpu_torch/csrc`` with nvcc (node
bounds 8, 21 and 64), holds it bit for bit against its plain PyTorch
version on the card (cases a-e at up to 8 nodes; f: split sharer
planes at 22, 33 and 64 nodes; g: packed planes), drives the streamed
fast path (``CudaEngine``) at the repo's headline width (32,768 systems
x 8 nodes x 128 instructions per core) and at its 64-node single-chip
width (1,024 systems x 64 nodes x 64 instructions, unpacked and
packed; ``scripts/scale_runs.py``'s single-device rung), the ``run``
command on a small trace directory and the ``bench`` command, and
prints:

* the card's name and power limit (``nvidia-smi``);
* one ``{"kernels": [...]}`` line: per kernel its launches on the
  64-node path, its largest disagreement with the plain version, its
  time and the plain version's at that shape, and its bytes bound
  (``by_path`` holds the same for every path driven);
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
    if 0 in launches.values():
        raise AssertionError(
            f"{label}: a kernel of the path never ran: {launches}")
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
    print(f"[bench] {batch} systems x 8 nodes x {instrs} instrs (engine "
          f"defaults: block 1024, one window, snapshots on): "
          f"{rec['seconds']} s, {rec['ops_per_sec']} RD/WR ops/s")


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
    print(f"[build] {secs:.1f} s: {names}")
    # registers, stack frame and spills of each instantiation
    for line in kernels.STREAM_RUN.build_log.splitlines():
        if any(w in line for w in ("Compiling entry", "Function properties",
                                   "registers", "spill")):
            print(f"[build] {line.strip()}")

    robust = Semantics().robust()
    t0 = time.perf_counter()
    err = phase_compare()
    t1 = time.perf_counter()
    err = max(err, phase_wide_compare())
    t2 = time.perf_counter()
    paths = {
        "headline": drive_path(
            "headline", SystemConfig(semantics=robust, **HEADLINE), 32768,
            128, HEADLINE_RUN, probe=(128, 256, 1024)),
        "wide": drive_path(
            "wide", SystemConfig(semantics=robust, **WIDE), 1024, 64,
            WIDE_RUN, probe=(64, 128, 256)),
    }
    paths["wide packed"] = drive_path(
        "wide packed", SystemConfig(semantics=robust, **WIDE), 1024, 64,
        WIDE_RUN, packed=True, ref=paths["wide"]["state"])
    t3 = time.perf_counter()
    phase_run_command()
    print(f"[wall] compare a-e {t1 - t0:.1f} s, compare f-g {t2 - t1:.1f} s,"
          f" full-width paths {t3 - t2:.1f} s, run command "
          f"{time.perf_counter() - t3:.1f} s")

    kern = kernels.STREAM_RUN
    wide = paths["wide"]
    print(json.dumps({"kernels": [{
        "name": kern.name, "route": "cuda", "source": kern.source,
        "replaces": kern.replaces,
        "variants": ["unsplit (num_procs <= 21)",
                     "split sharer planes (22 <= num_procs <= 64)",
                     "packed u8/u16 planes"],
        "launches": wide["launches"][kern.name],
        "max_abs_err": max([err] + [p["err"] for p in paths.values()]),
        "ms": wide["ms"], "plain_ms": wide["plain_ms"],
        "bound_ms": wide["bound_ms"], "bound_by": wide["bound_by"],
        "library_ms": None,
        "by_path": {name: {k: p[k] for k in (
            "launches", "ms", "plain_ms", "bound_ms", "bound_by")}
            for name, p in paths.items()},
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
