"""BASELINE.json's scaled configurations 4 and 5 on one NVIDIA GPU.

    python -m hpa2_tpu_torch.scripts.scale_runs [4|5|both] [--device cpu]

The port of ``scripts/scale_runs.py`` (l.46-147, l.522-543), with its
positional argument, defaults and JSON keys:

  config4: a 256-node system (8 sharer words, the scaling analog of the
           reference's 1-byte bitVector cap) x 4,096 producer-consumer
           instructions a core (~1M in all) on the general engine
           (``ops/engine.py:build_batched_run``), beyond the fast path's
           64-node bound on the card;
  config5: 1,024 systems x 8 nodes x 10,000 uniform instructions a core
           on the fast path (``CudaEngine``, K2), in trace windows of 32.

Each makes one warm run (on the card the first run builds the kernels or
captures the general engine's graph), then times a second on fresh state
with CUDA events around the run (``seconds``; the host's wall clock is
``wall_seconds``), prints one JSON line with the card's name and power
limit added, and returns the record.  :func:`config4_run` and
:func:`config5_run` return the final state or engine too, for callers
that check it (``chip_smoke.py``'s ``[scale]`` phase, the tests).

The JAX script's other modes (``multichip``, ``nodeshard``,
``nodeshard_ab``) and ``--data-shards N`` with N > 1 split the work over
several devices: the script exits 2 naming ROADMAP queue 1 item 4
(multi-GPU), and ``config5(data_shards=N)`` raises.
Without a card the script raises; ``--device cpu`` runs the plain
versions (tests, small sizes)."""

from __future__ import annotations

import json
import sys
import time

from hpa2_tpu_torch.config import Semantics, SystemConfig

#: the JAX script's modes that split a run over several devices
MULTI_DEVICE_MODES = ("multichip", "nodeshard", "nodeshard_ab")
#: what they raise
MULTI_DEVICE = ("{what} splits the run over several devices, which the "
                "port does not do yet (ROADMAP queue 1 item 4, multi-GPU)")


def _timed(fn, dev):
    """``fn()``: (its result, device ms by CUDA events or None on the
    CPU, wall seconds)."""
    import torch

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        end.record()
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return out, (start.elapsed_time(end) if cuda else None), wall


def _emit(rec: dict, dev, ms, wall) -> dict:
    from hpa2_tpu_torch.scripts.perf_sweep import _where

    secs = ms / 1e3 if ms is not None else wall
    rec.update(seconds=round(secs, 6), wall_seconds=round(wall, 6),
               ops_per_sec=round(rec["instructions"] / secs, 1),
               us_per_cycle=round(secs / max(rec["cycles"], 1) * 1e6, 3),
               **_where(dev))
    print(json.dumps(rec), flush=True)
    return rec


def config4_config() -> SystemConfig:
    """Configuration 4's system: 256 nodes, mailboxes of 64, traces read
    uncapped, robust semantics."""
    return SystemConfig(num_procs=256, msg_buffer_size=64, max_instr_num=0,
                        semantics=Semantics().robust())


def config5_config() -> SystemConfig:
    """Configuration 5's system: 8 nodes, mailboxes of 16, traces read
    uncapped, robust semantics."""
    return SystemConfig(num_procs=8, msg_buffer_size=16, max_instr_num=0,
                        semantics=Semantics().robust())


def config4_run(instrs_per_core: int = 4096, device="cuda"):
    """Configuration 4: (record, final ``SimState``, trace arrays)."""
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.cuda_engine import resolve_device
    from hpa2_tpu_torch.ops.engine import build_batched_run
    from hpa2_tpu_torch.ops.state import init_state_batched
    from hpa2_tpu_torch.ops.step import quiescent
    from hpa2_tpu_torch.utils.trace import gen_producer_consumer_arrays

    dev = resolve_device(device)
    config = config4_config()
    arrays = gen_producer_consumer_arrays(config, 1, instrs_per_core)
    run = build_batched_run(config, max_cycles=2_000_000)
    run(init_state_batched(config, *arrays, device=dev))  # capture + warm
    state = init_state_batched(config, *arrays, device=dev)
    syncs = kernels.HOST_SYNCS.count
    out, ms, wall = _timed(lambda: run(state), dev)
    syncs = kernels.HOST_SYNCS.count - syncs
    instrs = int(out.n_instr.sum())
    if not bool(quiescent(out).all()) or bool(out.overflow.any()) \
            or instrs != config.num_procs * instrs_per_core:
        raise RuntimeError(
            f"config4 did not complete: quiescent "
            f"{bool(quiescent(out).all())}, overflow "
            f"{bool(out.overflow.any())}, {instrs} of "
            f"{config.num_procs * instrs_per_core} instructions retired")
    cycles = int(out.cycle.max())
    rec = {
        "config": "4: 256-node x 1M producer-consumer (general engine)",
        "nodes": config.num_procs, "sharer_words": config.sharer_words,
        "instrs_per_core": instrs_per_core,
        "instructions": instrs, "cycles": cycles,
        "steps": cycles - int(out.n_elided.max()), "host_syncs": syncs,
    }
    return _emit(rec, dev, ms, wall), out, arrays


def config4(instrs_per_core: int = 4096, device="cuda") -> dict:
    """Configuration 4's JSON record (printed and returned)."""
    return config4_run(instrs_per_core, device)[0]


def config5_arrays(batch: int = 1024, instrs_per_core: int = 10_000,
                   dist=None, spread: float = 8.0):
    """Configuration 5's trace arrays (seed 0): uniform, or with
    per-system lengths drawn from ``dist``."""
    from hpa2_tpu_torch.utils.trace import (
        gen_heterogeneous_random_arrays, gen_uniform_random_arrays,
    )

    if dist:
        return gen_heterogeneous_random_arrays(
            config5_config(), batch, instrs_per_core, dist=dist,
            spread=spread)
    return gen_uniform_random_arrays(config5_config(), batch,
                                     instrs_per_core)


def config5_run(batch: int = 1024, instrs_per_core: int = 10_000,
                data_shards: int = 1, dist=None, spread: float = 8.0,
                schedule: bool = False, device="cuda", arrays=None):
    """Configuration 5: (record, the timed ``CudaEngine``, trace arrays).
    ``dist="zipf"`` draws per-system trace lengths (spread ``spread``)
    and ``schedule=True`` runs the occupancy scheduler (``Schedule()``),
    whose counters the record then carries.  ``arrays`` are
    :func:`config5_arrays`' for the same arguments, drawn already."""
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine, resolve_device
    from hpa2_tpu_torch.ops.layout import _SC_CYCLE
    from hpa2_tpu_torch.ops.schedule import Schedule

    if data_shards != 1:
        raise ValueError(MULTI_DEVICE.format(
            what=f"data_shards={data_shards}"))
    dev = resolve_device(device)
    config = config5_config()
    if arrays is None:
        arrays = config5_arrays(batch, instrs_per_core, dist, spread)
    kw = dict(block=512, cycles_per_call=128, snapshots=False,
              trace_window=32, device=dev)

    def build():
        return CudaEngine(config, *arrays,
                          schedule=Schedule() if schedule else None, **kw)

    build().run(max_cycles=5_000_000)  # build the kernels + warm
    eng = build()
    launches = kernels.CALLS.stream_run
    _, ms, wall = _timed(lambda: eng.run(max_cycles=5_000_000), dev)
    rec = {
        "config": "5: 1024-system x 10K-instr ensemble (fast path, K2)",
        "nodes": config.num_procs, "batch": batch,
        "instrs_per_core": instrs_per_core, "block": eng.block,
        "instructions": eng.instructions,
        "cycles": int(eng.state["scalars"][_SC_CYCLE].max()),
        "k2_launches": kernels.CALLS.stream_run - launches,
    }
    if dist:
        rec["trace_len_dist"] = {"dist": dist, "spread": spread}
    if schedule:
        rec["occupancy"] = eng.occupancy.as_dict()
    return _emit(rec, dev, ms, wall), eng, arrays


def config5(batch: int = 1024, instrs_per_core: int = 10_000,
            data_shards: int = 1, dist=None, spread: float = 8.0,
            schedule: bool = False, device="cuda") -> dict:
    """Configuration 5's JSON record (printed and returned)."""
    return config5_run(batch, instrs_per_core, data_shards, dist, spread,
                       schedule, device)[0]


def _arg(argv, name, default):
    if name in argv:
        return argv[argv.index(name) + 1]
    return default


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv and not argv[0].startswith("--") else "both"
    device = _arg(argv, "--device", "cuda")
    try:
        if which in MULTI_DEVICE_MODES:
            raise ValueError(MULTI_DEVICE.format(what=which))
        if which not in ("4", "5", "both"):
            raise ValueError(f"unknown configuration {which!r} (4, 5 or "
                             "both)")
        shards = int(_arg(argv, "--data-shards", 1))
        if shards != 1:
            raise ValueError(MULTI_DEVICE.format(
                what=f"--data-shards {shards}"))
        if which in ("4", "both"):
            config4(device=device)
        if which in ("5", "both"):
            config5(device=device)
    except ValueError as e:
        print(f"scale_runs: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
