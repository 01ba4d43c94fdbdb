"""BASELINE.json's scaled configurations 4 and 5, and the data-parallel
ladder, on NVIDIA GPUs.

    python -m hpa2_tpu_torch.scripts.scale_runs [4|5|both] [--data-shards N] [--device cpu]
    python -m hpa2_tpu_torch.scripts.scale_runs multichip [--device cpu]
    python -m hpa2_tpu_torch.scripts.scale_runs nodeshard_general [--device cpu]
    python -m hpa2_tpu_torch.scripts.scale_runs nodeshard|nodeshard_ab [--device cpu]

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

``--data-shards N`` runs configuration 5 over N cards
(``DataShardedCudaEngine``).  ``multichip`` (JAX l.150-213) is the
data-parallel ladder at the headline shape (8 nodes x 128 instructions,
block 512, window 32) over D = 1, 2, 4 cards (those present): weak
scaling (32,768 systems a card) and strong scaling (32,768 in all), each
run's planes held against one card's run of the same arrays; a row
holds the RD/WR rate, the wall time and each card's K2 time (CUDA events
on each card around the run).  ``nodeshard_general`` times the general
engine's node axis (``NodeShardedEngine``, 16 nodes) over 2 and 4 ranks
(as many cards) in the four exchange modes: ms a step and the
collectives of a cycle, each run held against ``TorchEngine``.
``nodeshard`` (JAX l.240-348) is the fast path's node-shard ladder: one
workload (on the card 64 nodes x 1,024 systems x 64 instructions, block
512, k 64, window 16) on one card (K2, ``CudaEngine``) and over 2 and 4
ranks (``NodeShardedCudaEngine``, one card each), every rung's planes
held against rung 1's, with ms a cycle, the collectives of a cycle and
the cross-shard traffic; ``nodeshard_ab`` (l.351-519) runs each rung in
the pairwise, a2a and butterfly schedules, interleaved best of
``reps``.  Without a card the script raises; ``--device cpu`` runs the
plain versions (tests, small sizes; the CPU's shards are logical and its
times not a scaling result)."""

from __future__ import annotations

import json
import sys
import time

from hpa2_tpu_torch.config import Semantics, SystemConfig

#: the fast path's node-shard ladder on the card (JAX l.264-277)
NODESHARD_RUN = dict(block=512, cycles_per_call=64, snapshots=False,
                     trace_window=16)


def _timed(fn, dev, devices=None):
    """``fn()``: (its result, device ms by CUDA events or None on the
    CPU, wall seconds).  With ``devices`` (a data mesh's cards) the ms
    are a list, one a card: events on each card's current stream around
    the run, and the wall clock waits for every card."""
    import torch

    cuda = dev.type == "cuda"
    cards = list(dict.fromkeys(devices or [dev]))
    if cuda:
        ev = []
        for d in cards:
            torch.cuda.synchronize(d)
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record(torch.cuda.current_stream(d))
            ev.append(pair)
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        for d, pair in zip(cards, ev):
            pair[1].record(torch.cuda.current_stream(d))
        for d in cards:
            torch.cuda.synchronize(d)
    wall = time.perf_counter() - t0
    if not cuda:
        return out, None, wall
    ms = [a.elapsed_time(b) for a, b in ev]
    return out, (ms if devices is not None else ms[0]), wall


def _emit(rec: dict, dev, ms, wall) -> dict:
    from hpa2_tpu_torch.scripts.perf_sweep import _where

    if isinstance(ms, list):  # one a card: the run is the wall clock
        rec["k2_ms_per_card"] = [round(x, 3) for x in ms]
        ms = None
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
    from hpa2_tpu_torch.parallel import DataShardedCudaEngine

    dev = resolve_device(device)
    config = config5_config()
    if arrays is None:
        arrays = config5_arrays(batch, instrs_per_core, dist, spread)
    kw = dict(block=512, cycles_per_call=128, snapshots=False,
              trace_window=32, device=dev)

    def build():
        sched = Schedule() if schedule else None
        if data_shards != 1:
            return DataShardedCudaEngine(config, *arrays, schedule=sched,
                                         data_shards=data_shards, **kw)
        return CudaEngine(config, *arrays, schedule=sched, **kw)

    build().run(max_cycles=5_000_000)  # build the kernels + warm
    eng = build()
    launches = kernels.CALLS.stream_run
    _, ms, wall = _timed(lambda: eng.run(max_cycles=5_000_000), dev,
                         getattr(getattr(eng, "mesh", None), "devices",
                                 None))
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
    if data_shards != 1:
        rec["data_shards"] = data_shards
    return _emit(rec, dev, ms, wall), eng, arrays


def config5(batch: int = 1024, instrs_per_core: int = 10_000,
            data_shards: int = 1, dist=None, spread: float = 8.0,
            schedule: bool = False, device="cuda") -> dict:
    """Configuration 5's JSON record (printed and returned)."""
    return config5_run(batch, instrs_per_core, data_shards, dist, spread,
                       schedule, device)[0]


#: the data ladder's headline shape (bench.py's): systems a card, node
#: count, instructions a core, and CudaEngine's keywords
LADDER_SYSTEMS = 32768
LADDER_RUN = dict(block=512, cycles_per_call=128, snapshots=False,
                  trace_window=32)


def multichip(per_card: int = LADDER_SYSTEMS, instrs_per_core: int = 128,
              device="cuda", shards=(1, 2, 4)) -> dict:
    """The data-parallel ladder (JAX ``multichip``): prints one JSON line
    a rung and the record, and returns the record."""
    import torch

    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine, resolve_device
    from hpa2_tpu_torch.parallel import DataShardedCudaEngine
    from hpa2_tpu_torch.scripts.perf_sweep import _where
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else max(shards)
    config = config5_config()
    rows, exact = [], True
    for scaling in ("weak", "strong"):
        for d in (s for s in shards if s <= cards):
            batch = per_card * d if scaling == "weak" else per_card
            arrays = gen_uniform_random_arrays(config, batch,
                                               instrs_per_core)
            one = CudaEngine(config, *arrays, device=dev, **LADDER_RUN)
            one.run(max_cycles=5_000_000)
            want = {f: v.cpu() for f, v in one.state.items()}
            del one

            def build():
                return DataShardedCudaEngine(config, *arrays,
                                             data_shards=d, device=dev,
                                             **LADDER_RUN)

            build().run(max_cycles=5_000_000)  # warm every card
            eng = build()
            launches = kernels.CALLS.stream_run
            syncs = kernels.HOST_SYNCS.count
            _, ms, wall = _timed(lambda: eng.run(max_cycles=5_000_000), dev,
                                 list(eng.mesh.devices))
            got = eng.state
            same = all(torch.equal(got[f], want[f]) for f in want)
            exact = exact and same
            row = {"scaling": scaling, "data_shards": d, "batch": batch,
                   "instructions": eng.instructions,
                   "seconds": round(wall, 6),
                   "ops_per_sec": round(eng.instructions / wall, 1),
                   "k2_ms_per_card": ([round(x, 3) for x in ms]
                                      if ms is not None else None),
                   "k2_launches": kernels.CALLS.stream_run - launches,
                   "host_syncs": kernels.HOST_SYNCS.count - syncs,
                   "bit_exact_vs_one_card": same}
            rows.append(row)
            print(json.dumps({"multichip_step": row}), flush=True)
    record = {
        "metric": "cuda_data_parallel_scaling", "unit": "RD/WR ops/sec",
        "cards": cards if dev.type == "cuda" else 0, "per_card": per_card,
        "instrs_per_core": instrs_per_core, "nodes": config.num_procs,
        # the CPU's shards share its cores: structure, not a scaling
        "indicative": dev.type == "cuda",
        "bit_exact_vs_one_card": bool(exact), "rows": rows,
        **_where(dev)}
    for scaling in ("weak", "strong"):
        mine = [r for r in rows if r["scaling"] == scaling]
        if len(mine) > 1:
            record[f"{scaling}_speedup_at_max_shards"] = round(
                mine[-1]["ops_per_sec"] / mine[0]["ops_per_sec"], 3)
    print(json.dumps(record), flush=True)
    if not exact:
        raise RuntimeError("a data-sharded run diverged from one card's")
    return record


def nodeshard_general(nodes: int = 16, instrs_per_core: int = 32,
                      ranks=(2, 4), device="cuda") -> dict:
    """The general engine's node axis: ``NodeShardedEngine`` at
    ``nodes`` nodes over each rank count of ``ranks`` (one card each on
    the card) in the four exchange modes, each against ``TorchEngine``
    on the same traces; ms a step is the slowest rank's timed loop over
    its steps."""
    import dataclasses

    import torch

    from hpa2_tpu_torch.ops.cuda_engine import resolve_device
    from hpa2_tpu_torch.ops.engine import TorchEngine
    from hpa2_tpu_torch.ops.exchange import make_plan, plan_collectives
    from hpa2_tpu_torch.parallel import NodeShardedEngine, make_mesh
    from hpa2_tpu_torch.parallel.sharding import run_node_sharded
    from hpa2_tpu_torch.scripts.perf_sweep import _where
    from hpa2_tpu_torch.utils.trace import gen_uniform_random

    dev = resolve_device(device)
    config = SystemConfig(num_procs=nodes, msg_buffer_size=16,
                          semantics=Semantics().robust())
    traces = gen_uniform_random(config, instrs_per_core, seed=1)
    ref = TorchEngine(config, traces, device=dev).run()
    cards = torch.cuda.device_count() if dev.type == "cuda" else max(ranks)
    rows, exact = [], True
    for d in (r for r in ranks if r <= cards):
        engs = []
        for mode in ("pairwise", "a2a", "butterfly", "hier"):
            cfg = dataclasses.replace(config, exchange_mode=mode)
            engs.append(NodeShardedEngine(
                cfg, traces, mesh=make_mesh(node_shards=d, data_shards=1,
                                            device=dev.type)))
        run_node_sharded(engs, warmup=True)
        for e in engs:
            same = (e.cycle == ref.cycle
                    and e.final_dumps() == ref.final_dumps()
                    and e.snapshots() == ref.snapshots()
                    and e.stats()["instructions"] == ref.instructions)
            exact = exact and same
            secs = max(r["seconds"] for r in e.rank_stats)
            steps = e.rank_stats[0]["steps"]
            plan = make_plan(d, e.config.exchange_mode,
                             e.config.exchange_inner)
            row = {"node_shards": d, "exchange_mode": e.config.exchange_mode,
                   "cycles": e.cycle, "steps": steps,
                   "ms_per_step": round(secs * 1e3 / max(steps, 1), 4),
                   "seconds": round(secs, 6),
                   "collectives_per_cycle": e.step_collectives,
                   "plan_collectives": plan_collectives(plan),
                   "loop_collectives": e.rank_stats[0]["loop_collectives"],
                   "exchange_sent": e.stats().get("exchange_sent", 0),
                   "equal_to_torch_engine": same}
            rows.append(row)
            print(json.dumps({"nodeshard_step": row}), flush=True)
    record = {"metric": "general_engine_node_sharding", "nodes": nodes,
              "instrs_per_core": instrs_per_core, "uncaptured": True,
              "equal_to_torch_engine": exact, "rows": rows, **_where(dev)}
    print(json.dumps(record), flush=True)
    if not exact:
        raise RuntimeError("a node-sharded run diverged from TorchEngine")
    return record


def _nodeshard_build(config, arrays, shards, dev):
    """Rung ``shards`` of the ladder: K2 on one card, else the
    node-sharded fast path over ``shards`` ranks (on the card its node
    cycle is the kernels N1-N4)."""
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
    from hpa2_tpu_torch.parallel import NodeShardedCudaEngine

    if shards == 1:
        return CudaEngine(config, *arrays, device=dev, **NODESHARD_RUN)
    return NodeShardedCudaEngine(config, *arrays, node_shards=shards,
                                 device=dev.type,
                                 **NODESHARD_RUN)


def _nodeshard_run(eng, dev, max_cycles=5_000_000):
    """Run one rung: (seconds, ms a cycle of the slowest rank or None on
    one card, the rung's CUDA kernels a cycle or None).  K2's seconds
    are CUDA events around its run (the wall clock on the CPU); a
    sharded rung's the slowest rank's timed loop after an untimed run in
    the same ranks (the spawn, the CUDA context and the NCCL
    communicators' creation are not counted), then in the same ranks one
    4-cycle call under ``torch.profiler`` (``NodeProfile``; on the card
    only).  K2 is warmed by the caller (its kernel's build)."""
    from hpa2_tpu_torch.parallel.sharding import NodeProfile, run_node_sharded

    if not hasattr(eng, "cross_shard_msgs"):
        _, ms, wall = _timed(lambda: eng.run(max_cycles=max_cycles), dev)
        return (ms / 1e3 if ms is not None else wall), None, None
    eng.max_cycles = max_cycles
    prof = NodeProfile(eng) if dev.type == "cuda" else None
    run_node_sharded([eng] + ([prof] if prof else []), warmup=True)
    slow = max(eng.rank_stats, key=lambda r: r["seconds"])
    return (slow["seconds"], slow["seconds"] * 1e3 / max(slow["cycles"], 1),
            prof.per_cycle if prof else None)


def _kernels_row(eng, per_cycle) -> dict:
    """What a sharded rung's JSON line says of its node cycle: which one
    ran, its kernels' launches on rank 0, and the CUDA kernels a cycle
    by ``torch.profiler`` (rank maximum)."""
    row = {"cycle": eng.node_cycle,
           "node_kernel_launches_rank0": eng.rank_stats[0]["launches"]}
    if per_cycle is not None:
        row.update(cuda_kernels_per_cycle=per_cycle["kernels"],
                   nccl_per_cycle=per_cycle["nccl"],
                   launch_calls_per_cycle=per_cycle["launch_calls"],
                   device_us_per_cycle=per_cycle["device_us"],
                   node_kernel_us_per_cycle=per_cycle["node_us"])
    return row


def _same_planes(eng, want) -> bool:
    import torch

    return all(torch.equal(eng.state[f].cpu(), v) for f, v in want.items())


def nodeshard(nodes: int = 64, batch: int = 1024, instrs_per_core: int = 64,
              ranks=(2, 4), device="cuda") -> dict:
    """The node-shard ladder (JAX ``nodeshard``): prints one JSON line a
    rung and the record, and returns the record; raises when a rung's
    planes differ from one card's."""
    import torch

    from hpa2_tpu_torch.ops import exchange as xops
    from hpa2_tpu_torch.ops.cuda_engine import resolve_device
    from hpa2_tpu_torch.scripts.perf_sweep import _where
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else max(ranks)
    config = SystemConfig(num_procs=nodes, msg_buffer_size=16,
                          max_instr_num=0, semantics=Semantics().robust())
    arrays = gen_uniform_random_arrays(config, batch, instrs_per_core)
    rows, want, exact = [], None, True
    for shards in (1,) + tuple(r for r in ranks if r <= cards):
        if shards == 1:  # warm: the kernel's build
            _nodeshard_build(config, arrays, 1, dev).run(
                max_cycles=5_000_000)
        eng = _nodeshard_build(config, arrays, shards, dev)
        secs, ms_cycle, per_cycle = _nodeshard_run(eng, dev)
        if want is None:
            want = {f: v.cpu() for f, v in eng.state.items()}
            same = True
        else:
            same = _same_planes(eng, want)
        exact = exact and same
        row = {"node_shards": shards, "instructions": eng.instructions,
               "cycles": eng.cycle, "seconds": round(secs, 6),
               "ops_per_sec": round(eng.instructions / secs, 1),
               "bit_exact_vs_one_card": same}
        if shards > 1:
            st = eng.rank_stats[0]
            xmsgs = eng.cross_shard_msgs
            row.update(
                ms_per_cycle=round(ms_cycle, 4),
                cycles_run=st["cycles"], calls=st["calls"],
                host_syncs=st["host_syncs"],
                cross_shard_msgs=xmsgs,
                cross_shard_msgs_per_cycle=round(
                    xmsgs / max(eng.cycle, 1), 2),
                exchange_bytes_per_cycle=eng.stats().get(
                    "exchange_bytes_per_cycle", 0),
                exchange_mode=config.exchange_mode,
                collectives_per_cycle=st["census"]["cycle"],
                plan_collectives=xops.plan_collectives(xops.make_plan(
                    shards, config.exchange_mode, config.exchange_inner)),
                **_kernels_row(eng, per_cycle))
        rows.append(row)
        print(json.dumps({"nodeshard_step": row}), flush=True)
    record = {
        "metric": "cuda_node_shard_scaling", "unit": "RD/WR ops/sec",
        "cards": cards if dev.type == "cuda" else 0,
        "indicative": dev.type == "cuda", "nodes": nodes, "batch": batch,
        "instrs_per_core": instrs_per_core,
        "bit_exact_vs_one_card": bool(exact), "shards": rows,
        **_where(dev)}
    print(json.dumps(record), flush=True)
    if not exact:
        raise RuntimeError("a node-sharded rung diverged from one card's")
    return record


def nodeshard_ab(nodes: int = 64, batch: int = 1024,
                 instrs_per_core: int = 64, ranks=(2, 4), reps: int = 3,
                 device="cuda") -> dict:
    """The exchange schedules' A/B ladder (JAX ``nodeshard_ab``): at each
    rung the pairwise, a2a and butterfly schedules, and ``hier`` (not an
    arm of JAX's: its combining count runs only there), interleaved best
    of ``reps`` (a spawn a run, timed after an untimed run in its
    ranks), every arm's planes held against one
    card's run."""
    import dataclasses

    import torch

    from hpa2_tpu_torch.ops import exchange as xops
    from hpa2_tpu_torch.ops.cuda_engine import resolve_device
    from hpa2_tpu_torch.scripts.perf_sweep import _where
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else max(ranks)
    base = SystemConfig(num_procs=nodes, msg_buffer_size=16,
                        max_instr_num=0, semantics=Semantics().robust())
    arrays = gen_uniform_random_arrays(base, batch, instrs_per_core)
    _nodeshard_build(base, arrays, 1, dev).run(max_cycles=5_000_000)
    ref = _nodeshard_build(base, arrays, 1, dev)
    ref_dt, _, _ = _nodeshard_run(ref, dev)
    want = {f: v.cpu() for f, v in ref.state.items()}
    single = {"instructions": ref.instructions, "seconds": round(ref_dt, 6),
              "ops_per_sec": round(ref.instructions / ref_dt, 1)}
    print(json.dumps({"nodeshard_ab_single": single}), flush=True)
    arms = (("old_pairwise", "pairwise"), ("new_a2a", "a2a"),
            ("new_butterfly", "butterfly"), ("new_hier", "hier"))
    rows, exact = [], True
    for shards in (r for r in ranks if r <= cards):
        row = {"node_shards": shards}
        best = {}
        for _ in range(reps):
            for label, mode in arms:
                cfg = dataclasses.replace(base, exchange_mode=mode)
                eng = _nodeshard_build(cfg, arrays, shards, dev)
                secs, ms_cycle, per_cycle = _nodeshard_run(eng, dev)
                if secs < best.get(label, (float("inf"),))[0]:
                    best[label] = (secs, ms_cycle, eng, per_cycle)
        for label, mode in arms:
            secs, ms_cycle, eng, per_cycle = best[label]
            same = _same_planes(eng, want)
            exact = exact and same
            row[label] = {
                "exchange_mode": mode,
                "collectives_per_cycle": eng.rank_stats[0]["census"]["cycle"],
                "plan_collectives": xops.plan_collectives(
                    xops.make_plan(shards, mode, 0)),
                "seconds": round(secs, 6), "ms_per_cycle": round(ms_cycle, 4),
                "ops_per_sec": round(eng.instructions / secs, 1),
                "cross_shard_msgs": eng.cross_shard_msgs,
                "bit_exact": same, **_kernels_row(eng, per_cycle)}
        old = max(row["old_pairwise"]["ops_per_sec"], 1e-9)
        for label in ("a2a", "butterfly", "hier"):
            row[f"{label}_speedup_vs_pairwise"] = round(
                row[f"new_{label}"]["ops_per_sec"] / old, 3)
        rows.append(row)
        print(json.dumps({"nodeshard_ab_step": row}), flush=True)
    record = {
        "metric": "cuda_node_shard_exchange_ab", "unit": "RD/WR ops/sec",
        "cards": cards if dev.type == "cuda" else 0,
        "indicative": dev.type == "cuda", "nodes": nodes, "batch": batch,
        "instrs_per_core": instrs_per_core, "reps": reps,
        "single_card": single, "bit_exact_vs_one_card": bool(exact),
        "shards": rows, **_where(dev)}
    print(json.dumps(record), flush=True)
    if not exact:
        raise RuntimeError("an A/B arm diverged from one card's run")
    return record


def _arg(argv, name, default):
    if name in argv:
        return argv[argv.index(name) + 1]
    return default


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv and not argv[0].startswith("--") else "both"
    device = _arg(argv, "--device", "cuda")
    try:
        # the CPU's runs are the plain versions: small sizes
        cpu = device == "cpu"
        small = dict(nodes=8, batch=4, instrs_per_core=8, ranks=(2,))
        if which == "nodeshard":
            nodeshard(**(small if cpu else {}), device=device)
            return 0
        if which == "nodeshard_ab":
            nodeshard_ab(**(dict(small, reps=1) if cpu else {}),
                         device=device)
            return 0
        if which == "multichip":
            multichip(**(dict(per_card=8, instrs_per_core=8) if cpu
                         else {}), device=device)
            return 0
        if which == "nodeshard_general":
            nodeshard_general(**(dict(nodes=8, instrs_per_core=8,
                                      ranks=(2,)) if cpu else {}),
                              device=device)
            return 0
        if which not in ("4", "5", "both"):
            raise ValueError(f"unknown configuration {which!r} (4, 5, "
                             "both, multichip, nodeshard_general, "
                             "nodeshard or nodeshard_ab)")
        shards = int(_arg(argv, "--data-shards", 1))
        if which in ("4", "both"):
            config4(device=device)
        if which in ("5", "both"):
            config5(data_shards=shards, device=device)
    except ValueError as e:
        print(f"scale_runs: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
