"""The port's benchmark: ``bench.py``'s studies on one GPU, with its
environment knobs and JSON keys.

    python -m hpa2_tpu_torch.bench                 # the headline
    python -m hpa2_tpu_torch.bench --serve         # always-on serving
    python -m hpa2_tpu_torch.bench --failover      # recovery latency
    python -m hpa2_tpu_torch.bench --topology      # interconnect study
    python -m hpa2_tpu_torch.bench --protocol      # protocol study
    python -m hpa2_tpu_torch.bench --device cpu    # the CPU smoke shape

Each prints one JSON line (``bench.py:197-1268``).

* **The headline** (``child_main``, ``bench.py:371-535``): the fast
  path (``CudaEngine``, K2 with K1 inlined) on an ensemble of 8-node
  robust systems, ``msg_buffer_size=16``, uniform-random traces,
  32,768 x 8 x 128 on the card (8 x 16 on the CPU), block 512, window
  32, 128 cycles a call, run to quiescence, timed around ``run()`` with
  the device synchronised on both sides (the warm-up run, which builds
  the kernel, stays outside the clock).  Beside it: the RD/WR rate of
  the OpenMP baseline (``native.py``, free-running, 50,000
  instructions a core) as ``vs_baseline``, the native lockstep rate,
  the general engine's rate on a batch of 1,024 (``jax_engine``, the
  context ``bench_jax`` gives), and the fault counters of a small
  faulty ensemble on ``BatchTorchEngine``.  ``HPA2_BENCH_TRACE_DIST`` /
  ``_SPREAD``, ``_SCHEDULE_RESIDENT``, ``_HOST_BARRIERS``, ``_PACKED``
  and ``_NO_ELIDE`` (or their flags) select the workload and path.
* ``--serve`` and ``--failover`` (``bench.py:538-815``): the serving
  plane and the recovery supervisor (``serving/``), sized by
  ``HPA2_SERVE_*`` and ``HPA2_FAILOVER_AT``.
* ``--topology`` and ``--protocol`` (``bench.py:1037-1268``): model
  numbers of the port's spec engine on the host, every row
  cross-checked against the general engine (``TorchEngine``) on the
  device (``spec_jax_agree_all`` keeps its name), sized by
  ``HPA2_TOPO_*`` and ``HPA2_PROTO_*``.

``platform`` is ``"gpu"`` on the card and ``"cpu"`` otherwise,
``indicative`` is true only on the card, and ``device`` names the card
and its power limit (``nvidia-smi``).  There is no fallback: a failed
fast path, a failed baseline or a missing card ends the run with a
nonzero exit and no JSON line, and no earlier record is read or
written.  ``--data-shards N`` (``HPA2_BENCH_DATA_SHARDS``) splits the
headline's ensemble over N cards (``DataShardedCudaEngine``; the batch
is rounded up to a multiple of N) and serves ``--serve`` on
``pallas-sharded``; ``--node-shards N`` (``HPA2_BENCH_NODE_SHARDS``)
splits each system's nodes over N ranks (``NodeShardedCudaEngine``, a
``data x node`` grid with ``--data-shards``; the record gains the
``exchange`` block) and ``--exchange-mode`` picks the exchange's
schedule (``HPA2_BENCH_EXCHANGE_MODE``, ``a2a`` by default).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from hpa2_tpu_torch.ops.cuda_engine import resolve_device

# the headline's shape on the card and the fast path's kernel shape
# (``bench.py:50-52``; the port reads no TPU tuning file)
_CARD_BATCH, _CARD_INSTRS = 32768, 128
_CPU_BATCH, _CPU_INSTRS = 8, 16
_BLOCK, _CAP, _WINDOW, _K = 512, 16, 32, 128
_GATE = True
#: the OpenMP baseline's and the native lockstep context's length
_OMP_INSTRS = 50_000
#: the general engine's context batch on the card
_JAX_CONTEXT_BATCH = 1024


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _data_shards() -> int:
    """``--data-shards``: the headline's and serving's cards."""
    return max(1, _env_int("HPA2_BENCH_DATA_SHARDS", 1))


def _node_shards() -> int:
    """``--node-shards``: the ranks each system's nodes split over
    (composes with ``--data-shards`` into a ``data x node`` grid)."""
    return max(1, _env_int("HPA2_BENCH_NODE_SHARDS", 1))


def _exchange_mode() -> str:
    """``--exchange-mode``: the cross-shard schedule (``ops/exchange.py``),
    observable only under ``--node-shards`` > 1."""
    return os.environ.get("HPA2_BENCH_EXCHANGE_MODE", "").strip() or "a2a"


def _no_elide() -> bool:
    """``--no-elide``: the general engine's runs as pure lockstep."""
    return os.environ.get("HPA2_BENCH_NO_ELIDE", "") == "1"


def _packed() -> bool:
    """``--packed``: the fast path on packed planes."""
    return os.environ.get("HPA2_BENCH_PACKED", "") == "1"


def _schedule_knobs():
    """(resident, fused): ``--schedule-resident N`` turns the occupancy
    scheduler on (0 = off), ``--host-barriers`` runs it one host-synced
    interval at a time instead of fused."""
    resident = _env_int("HPA2_BENCH_SCHEDULE_RESIDENT", 0)
    fused = os.environ.get("HPA2_BENCH_HOST_BARRIERS", "") != "1"
    return max(0, resident), fused


def _trace_len_dist():
    """(dist, spread): heterogeneous per-system trace lengths, or
    (None, spread) for every trace the full length."""
    dist = os.environ.get("HPA2_BENCH_TRACE_DIST", "").strip() or None
    try:
        spread = float(os.environ.get("HPA2_BENCH_TRACE_SPREAD", "8"))
    except ValueError:
        spread = 8.0
    return dist, max(1.0, spread)


def _bench_config():
    from hpa2_tpu_torch.config import Semantics, SystemConfig

    return SystemConfig(
        num_procs=8, msg_buffer_size=_CAP,
        semantics=Semantics().robust(),
        elide=not _no_elide(),
        exchange_mode=_exchange_mode(),
    )


def card_info(dev: torch.device) -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (a card set below its maximum runs slower under load)."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    name, _, limit = out.stdout.strip().splitlines()[idx].partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# the headline
# ---------------------------------------------------------------------------

def bench_pallas(config, batch, instrs_per_core, seed=0, dist=None,
                 spread=8.0, packed=False, schedule_resident=0, fused=True,
                 device="cuda", data_shards=1, node_shards=1):
    """The fast path on ``batch`` systems (``bench.py:197-318``):
    warm-up, then a timed run split into host staging (building the
    engine: packing and uploading the planes), device execution and the
    counter readback; ``data_shards > 1`` over that many cards,
    ``node_shards > 1`` each system's nodes over that many ranks (device
    execution is then the slowest rank's run, timed on the rank after an
    untimed run in the same ranks).
    -> (instructions, seconds, occupancy, exchange, phases), ``exchange``
    None unless node-sharded."""
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
    from hpa2_tpu_torch.ops.schedule import Schedule
    from hpa2_tpu_torch.utils.trace import (
        gen_heterogeneous_random_arrays, gen_uniform_random_arrays,
    )

    dev = resolve_device(device)
    schedule = None
    if schedule_resident:
        schedule = Schedule(resident=min(schedule_resident, batch),
                            fused=fused)
    occupancy = None
    if dist:
        from hpa2_tpu_torch.analysis.occupancy import predicted_stats
        from hpa2_tpu_torch.ops.layout import choose_block
        from hpa2_tpu_torch.utils.trace import heterogeneous_lengths

        arrays = gen_heterogeneous_random_arrays(
            config, batch, instrs_per_core, dist=dist, spread=spread,
            seed=seed)
        # the static occupancy model over the same lengths: what
        # ``schedule=`` would save, recorded beside the measured run
        lens = heterogeneous_lengths(batch, instrs_per_core, dist=dist,
                                     spread=spread, seed=seed)
        occupancy = predicted_stats(
            lens, _WINDOW, choose_block(batch // data_shards, _BLOCK),
            groups=data_shards).as_dict()
    else:
        arrays = gen_uniform_random_arrays(config, batch, instrs_per_core,
                                           seed=seed)

    def build():
        kw = dict(block=_BLOCK, cycles_per_call=_K, snapshots=False,
                  trace_window=_WINDOW, gate=_GATE, packed=packed,
                  schedule=schedule)
        if node_shards > 1:
            from hpa2_tpu_torch.parallel import NodeShardedCudaEngine

            return NodeShardedCudaEngine(
                config, *arrays, node_shards=node_shards,
                data_shards=data_shards, device=dev, **kw)
        if data_shards > 1:
            from hpa2_tpu_torch.parallel import DataShardedCudaEngine

            return DataShardedCudaEngine(config, *arrays,
                                         data_shards=data_shards,
                                         device=dev, **kw)
        return CudaEngine(config, *arrays, device=dev, **kw)

    def sync_all():
        if dev.type == "cuda":
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)

    if node_shards == 1:
        build().run()  # builds the kernel, warms the caches
    sync_all()
    t0 = time.perf_counter()
    eng = build()
    sync_all()
    stage_s = time.perf_counter() - t0
    if node_shards > 1:
        # the slowest rank's timed run, after an untimed one in the same
        # ranks: the spawn, the CUDA contexts and the NCCL communicators'
        # creation are not counted
        eng.run(warmup=True)
        dt = max(r["seconds"] for r in eng.rank_stats)
    else:
        t0 = time.perf_counter()
        eng.run()
        sync_all()
        dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    instrs = eng.instructions
    read_s = time.perf_counter() - t0
    phases = {
        "host_staging_s": round(stage_s, 4),
        "device_execute_s": round(dt, 4),
        "readback_s": round(read_s, 4),
    }
    exchange = None
    if node_shards > 1:
        from hpa2_tpu_torch.ops import exchange as xops

        xmsgs = eng.cross_shard_msgs
        cycles = max(eng.cycle, 1)
        plan = xops.make_plan(node_shards, config.exchange_mode,
                              config.exchange_inner)
        stats = eng.stats()
        exchange = {
            "node_shards": node_shards,
            "exchange_mode": config.exchange_mode,
            "collectives_per_cycle": xops.plan_collectives(plan),
            "exchange_slots": 5 * (config.num_procs // node_shards),
            "cross_shard_msgs": xmsgs,
            "cross_shard_msgs_per_cycle": round(xmsgs / cycles, 2),
            "exchange_slot_hwm": stats.get("exchange_slot_hwm", 0),
            "exchange_bytes_per_cycle": stats.get(
                "exchange_bytes_per_cycle", 0),
            "exchange_multicast_saved": stats.get(
                "exchange_multicast_saved", 0),
            "exchange_combined": stats.get("exchange_combined", 0),
            "msgs_total": eng.messages,
        }
    if schedule is not None:
        occupancy = eng.occupancy.as_dict()
    return instrs, dt, occupancy, exchange, phases


def bench_jax(config, batch, instrs_per_core, seed=0, device="cuda"):
    """The general engine's batch loop on ``batch`` uniform systems
    (``bench.py:321-359``): warm-up (on the card it captures the loop's
    graph), then the timed run.  -> (instructions, seconds, elision
    counters that fired)."""
    from hpa2_tpu_torch.ops.engine import build_batched_run
    from hpa2_tpu_torch.ops.state import init_state_batched
    from hpa2_tpu_torch.ops.step import quiescent
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    dev = resolve_device(device)
    state = init_state_batched(
        config,
        *gen_uniform_random_arrays(config, batch, instrs_per_core, seed=seed),
        device=dev)
    run = build_batched_run(config, max_cycles=1_000_000)
    run(state)
    _sync(dev)
    t0 = time.perf_counter()
    out = run(state)
    _sync(dev)
    dt = time.perf_counter() - t0
    if bool(out.overflow.any()):
        raise RuntimeError("general engine: mailbox overflow")
    if not bool(quiescent(out).all()):
        raise RuntimeError(
            "general engine: the batch hit max_cycles before quiescence; "
            "the rate would be over a partial workload")
    counters = {}
    for key, field in (("elided_cycles", out.n_elided),
                       ("multi_hit_retired", out.n_multi_hit)):
        val = int(field.sum())
        if val:
            counters[key] = val
    return int(out.n_instr.sum()), dt, counters


def bench_omp(config, instrs_per_core, seed=0, mode="omp"):
    """The C++/OpenMP engine's uniform-random benchmark; raises if it
    does not build or run."""
    from hpa2_tpu_torch import native

    res = native.bench_random(config, instrs_per_core=instrs_per_core,
                              seed=seed, mode=mode)
    return int(res.instructions), float(res.seconds)


def fault_counters(config, device="cuda") -> dict:
    """The link-layer fault counters of a small faulty ensemble on the
    general engine (seeded fault stream, fixed traces)."""
    from hpa2_tpu_torch.config import FaultModel
    from hpa2_tpu_torch.ops.engine import BatchTorchEngine
    from hpa2_tpu_torch.utils.trace import gen_uniform_random

    fcfg = dataclasses.replace(
        config,
        interconnect=dataclasses.replace(
            config.interconnect,
            fault=FaultModel(drop=0.2, duplicate=0.05, reorder=0.05,
                             delay=0.1, seed=7),
        ),
    )
    eng = BatchTorchEngine(
        fcfg, [gen_uniform_random(fcfg, 16, seed=s) for s in range(4)],
        device=device).run()
    return {k: v for k, v in eng.stats().items() if k.startswith("fault_")}


def headline_main(device: str = "cuda") -> dict:
    """``bench.py``'s ``child_main`` on the port (``bench.py:371-535``)
    -> the JSON record."""
    dev = resolve_device(device)
    config = _bench_config()
    on_card = dev.type == "cuda"
    batch, instrs_per_core = ((_CARD_BATCH, _CARD_INSTRS) if on_card
                              else (_CPU_BATCH, _CPU_INSTRS))
    shards = _data_shards()
    if batch % shards:  # the ensemble splits into equal lane groups
        batch = -(-batch // shards) * shards
    dist, spread = _trace_len_dist()
    packed = _packed()
    resident, fused = _schedule_knobs()
    node_shards = _node_shards()
    instrs, dt, occupancy, exchange, phases = bench_pallas(
        config, batch, instrs_per_core, dist=dist, spread=spread,
        packed=packed, schedule_resident=resident, fused=fused, device=dev,
        data_shards=shards, node_shards=node_shards)
    ops = instrs / dt
    result = {
        "metric": "sim_ops_per_sec_jax",
        "value": round(ops, 1),
        "unit": "RD/WR ops/sec",
        "vs_baseline": None,
        "engine": "pallas",
        "platform": "gpu" if on_card else "cpu",
        # the CPU smoke shape (batch 8, the plain versions) measures
        # nothing representative
        "indicative": on_card,
        "batch": batch,
        "jax_instrs": instrs,
        "jax_seconds": round(dt, 4),
        "packed_planes": packed,
        "elide": config.elide,
        "fused_schedule": bool(resident and fused),
    }
    if resident:
        result["schedule"] = {"resident": resident, "fused": fused}
    if dist:
        result["trace_len_dist"] = {"dist": dist, "spread": spread}
    if occupancy is not None:
        result["occupancy"] = occupancy
    result["phases"] = phases
    if shards != 1:
        result["data_shards"] = shards
        result["n_devices"] = torch.cuda.device_count() if on_card else 0
    if node_shards != 1:
        result["node_shards"] = node_shards
        result["n_devices"] = torch.cuda.device_count() if on_card else 0
        result["cross_shard_msgs_per_cycle"] = exchange[
            "cross_shard_msgs_per_cycle"]
        result["exchange"] = exchange
        print(f"[pallas] cross-shard msgs: {exchange['cross_shard_msgs']} "
              f"({exchange['cross_shard_msgs_per_cycle']}/cycle)",
              file=sys.stderr)
    result["kernel_shape"] = {"block": _BLOCK, "window": _WINDOW, "k": _K,
                              "gate": _GATE}
    if on_card:
        # the OpenMP ratio means something only at the card's shape
        omp_instrs, omp_dt = bench_omp(config, instrs_per_core=_OMP_INSTRS)
        omp_ops = omp_instrs / omp_dt
        result.update(
            vs_baseline=round(ops / omp_ops, 2),
            omp_ops_per_sec=round(omp_ops, 1),
            omp_instrs=omp_instrs,
            omp_seconds=round(omp_dt, 4),
        )
    ls_instrs, ls_dt = bench_omp(config, instrs_per_core=_OMP_INSTRS,
                                 mode="lockstep")
    result["native_lockstep_ops_per_sec"] = round(ls_instrs / ls_dt, 1)
    jb = _JAX_CONTEXT_BATCH if on_card else batch
    j_instrs, j_dt, elision = bench_jax(config, jb, instrs_per_core,
                                        device=dev)
    result["jax_engine"] = {
        "batch": jb, "instrs": j_instrs, "seconds": round(j_dt, 4),
        "ops_per_sec": round(j_instrs / j_dt, 1), **elision,
    }
    result["fault_counters"] = fault_counters(config, device=dev)
    result["device"] = card_info(dev)
    return result


# ---------------------------------------------------------------------------
# serving and failover
# ---------------------------------------------------------------------------

def _serve_knobs(on_card: bool):
    """The serving geometry, overridable by ``HPA2_SERVE_*``."""
    resident = _env_int("HPA2_SERVE_RESIDENT", 4096 if on_card else 8)
    jobs_n = _env_int("HPA2_SERVE_JOBS", 4 * resident)
    instrs = _env_int("HPA2_SERVE_INSTRS", 128 if on_card else 24)
    window = _env_int("HPA2_SERVE_WINDOW", _WINDOW if on_card else 8)
    block = _env_int("HPA2_SERVE_BLOCK", _BLOCK if on_card else 8)
    policy = os.environ.get("HPA2_SERVE_POLICY", "fcfs")
    backend = os.environ.get("HPA2_SERVE_BACKEND", "pallas")
    if backend == "pallas" and _data_shards() > 1:
        backend = "pallas-sharded"
    return resident, jobs_n, instrs, window, block, policy, backend


def serve_main(device: str = "cuda") -> dict:
    """``bench.py --serve`` (``serve_child_main``, l.559-694): capacity
    pipelined and serial, Poisson and zipf-burst arrivals at 60% of the
    measured capacity, and a four-tenant fair-drr pass."""
    from hpa2_tpu_torch.serving import (
        ListJobSource, poisson_arrivals, serve, synthetic_jobs,
        zipf_burst_arrivals)

    dev = resolve_device(device)
    config = _bench_config()
    on_card = dev.type == "cuda"
    (resident, jobs_n, instrs, window, block, policy,
     backend) = _serve_knobs(on_card)

    def _serve(jobs, *, overlap, timed=False):
        return serve(
            config, ListJobSource(jobs, timed=timed), backend=backend,
            resident=resident, window=window, block=block,
            policy=policy, overlap=overlap, max_trace_len=instrs,
            decode_dumps=False, device=dev, data_shards=_data_shards(),
        )

    jobs = synthetic_jobs(config, jobs_n, instrs, seed=0, dist="zipf",
                          spread=4.0)
    # warm-up: build the kernel so the measured runs compare staging
    _serve(synthetic_jobs(config, min(jobs_n, 2 * resident), instrs,
                          seed=99, dist="zipf", spread=4.0), overlap=True)

    _, pipelined = _serve(jobs, overlap=True)
    _, serial = _serve(jobs, overlap=False)
    hidden_s = max(0.0, serial.wall_s - pipelined.wall_s)
    overlap_cmp = {
        "pipelined_wall_s": round(pipelined.wall_s, 4),
        "serial_wall_s": round(serial.wall_s, 4),
        "hidden_s": round(hidden_s, 4),
        "staging_hidden_frac": round(
            min(1.0, hidden_s / serial.host_staging_s), 3
        ) if serial.host_staging_s > 0 else 0.0,
    }

    capacity = max(pipelined.jobs_completed / pipelined.wall_s, 1e-9)
    rate = 0.6 * capacity
    arr_runs = {}
    for name, arrivals in (
        ("poisson", poisson_arrivals(jobs_n, rate, seed=1)),
        ("zipf_burst", zipf_burst_arrivals(jobs_n, rate, seed=1)),
    ):
        feed = synthetic_jobs(config, jobs_n, instrs, seed=2, dist="zipf",
                              spread=4.0, arrivals=arrivals)
        _, st = _serve(feed, overlap=True, timed=True)
        rec = st.as_dict()
        rec["arrival_rate_jobs_per_s"] = round(rate, 2)
        arr_runs[name] = rec

    weights = {"t0": 1.0, "t1": 2.0, "t2": 4.0, "t3": 8.0}
    names = sorted(weights)
    mt_jobs = synthetic_jobs(config, jobs_n, instrs, seed=3, dist="zipf",
                             spread=4.0)
    for i, j in enumerate(mt_jobs):
        j.tenant = names[i % len(names)]
        j.deadline = (8, 32, -1)[i % 3]
    mt_res, mt_st = serve(
        config, ListJobSource(mt_jobs), backend=backend,
        resident=resident, window=window, block=block, policy="fair-drr",
        overlap=True, max_trace_len=instrs, decode_dumps=False,
        tenant_weights=weights, device=dev, data_shards=_data_shards(),
    )
    per_tenant = {}
    for name in names:
        lat = np.asarray([r.latency_s for r in mt_res if r.tenant == name])
        if len(lat):
            per_tenant[name] = {
                "jobs": int(len(lat)),
                "p50_s": round(float(np.percentile(lat, 50)), 6),
                "p99_s": round(float(np.percentile(lat, 99)), 6),
            }
    mt_occ = mt_st.occupancy
    return {
        "metric": "serving_sustained_ops_per_sec",
        "value": round(pipelined.ops_per_s, 1),
        "unit": "RD/WR ops/sec",
        "platform": "gpu" if on_card else "cpu",
        "indicative": on_card,
        "backend": backend,
        "resident": resident,
        "jobs": jobs_n,
        "instrs_per_core": instrs,
        "window": window,
        "block": block,
        "policy": pipelined.policy,
        "elide": config.elide,
        "data_shards": _data_shards(),
        "overlap": overlap_cmp,
        "capacity_pipelined": pipelined.as_dict(),
        "capacity_serial": serial.as_dict(),
        "arrivals": arr_runs,
        "multi_tenant": {
            "policy": mt_st.policy,
            "tenant_weights": weights,
            "deadline_met": mt_occ.get("deadline_met", 0),
            "deadline_missed": mt_occ.get("deadline_missed", 0),
            "deadline_hit_rate": mt_occ.get("deadline_hit_rate"),
            "tenant_share": mt_occ.get("tenant_share"),
            "per_tenant_latency_s": per_tenant,
        },
        "device": card_info(dev),
    }


def failover_main(device: str = "cuda") -> dict:
    """``bench.py --failover`` (``failover_child_main``, l.697-810): the
    unfailed baseline, one supervised run per failure kind (kill, hang,
    poison at interval ``HPA2_FAILOVER_AT``) against its dumps, and a
    mid-frame wire sever ridden out by a retrying client."""
    import tempfile
    import threading

    from hpa2_tpu_torch.config import FailurePlan
    from hpa2_tpu_torch.service import WireClient, WireJobSource
    from hpa2_tpu_torch.serving import (
        ListJobSource, job_to_record, serve, supervised_serve,
        synthetic_jobs)

    dev = resolve_device(device)
    config = _bench_config()
    on_card = dev.type == "cuda"
    (resident, jobs_n, instrs, window, block, policy,
     backend) = _serve_knobs(on_card)
    fail_at = _env_int("HPA2_FAILOVER_AT", 3)
    kw = dict(backend=backend, resident=resident, window=window,
              block=block, policy=policy, max_trace_len=instrs,
              decode_dumps=False, device=dev)
    jobs = synthetic_jobs(config, jobs_n, instrs, seed=0, dist="zipf",
                          spread=4.0)

    def _dump_map(res):
        return {r.job_id: tuple(repr(d) for d in r.dumps) for r in res}

    serve(config, ListJobSource(synthetic_jobs(
        config, min(jobs_n, 2 * resident), instrs, seed=99, dist="zipf",
        spread=4.0)), **kw)
    t0 = time.perf_counter()
    base_res, _ = serve(config, ListJobSource(jobs), **kw)
    base_wall = time.perf_counter() - t0
    want = _dump_map(base_res)

    runs = {}
    for kind, spec in (("kill", f"kill@{fail_at}"),
                       ("hang", f"hang@{fail_at}"),
                       ("poison", f"poison@{fail_at}:1")):
        plan = FailurePlan.parse(spec, seed=11)
        with tempfile.TemporaryDirectory() as td:
            t0 = time.perf_counter()
            res, st = supervised_serve(config, ListJobSource(jobs),
                                       plan=plan, checkpoint_dir=td, **kw)
            wall = time.perf_counter() - t0
        rec = dict(st.occupancy.get("recovery", {}))
        rec.pop("events", None)
        runs[kind] = {
            "wall_s": round(wall, 4),
            "recovery_overhead_s": round(max(0.0, wall - base_wall), 4),
            "byte_identical": _dump_map(res) == want,
            **rec,
        }

    sever_plan = FailurePlan.parse("sever@2", seed=7)
    src = WireJobSource(config, failures=sever_plan)
    recs = [job_to_record(j) for j in jobs[:min(8, len(jobs))]]
    blackout = {}

    def client():
        cli = WireClient(*src.address, timeout_s=30.0, retries=4,
                         backoff_s=0.02, backoff_seed=11)
        worst = 0.0
        for r in recs:
            t0 = time.perf_counter()
            cli.submit(r)
            worst = max(worst, time.perf_counter() - t0)
        cli.finish()
        blackout["blackout_s"] = round(worst, 4)
        blackout["client_retries"] = cli.retries
        blackout["session"] = cli.session
        cli.close()

    t = threading.Thread(target=client, daemon=True)
    t.start()
    try:
        serve(config, src, emit=src.deliver, **kw)
    finally:
        src.close()
    t.join(timeout=120)
    if t.is_alive():
        raise RuntimeError("failover bench: the wire client did not finish")

    return {
        "metric": "failover_recovery_overhead_s",
        "value": runs["kill"]["recovery_overhead_s"],
        "unit": "seconds",
        "platform": "gpu" if on_card else "cpu",
        "indicative": on_card,
        "backend": backend,
        "resident": resident,
        "jobs": jobs_n,
        "instrs_per_core": instrs,
        "fail_at_interval": fail_at,
        "baseline_wall_s": round(base_wall, 4),
        "runs": runs,
        "wire_sever": blackout,
        "device": card_info(dev),
    }


# ---------------------------------------------------------------------------
# the model studies: spec engine on the host, general engine on the device
# ---------------------------------------------------------------------------

def _final_dicts(eng) -> list:
    return [dataclasses.asdict(d) for d in eng.final_dumps()]


def topo_main(device: str = "cuda") -> dict:
    """``bench.py --topology`` (``topo_main``, l.1037-1146): the
    invalidation storm's cycles under every non-ideal topology and
    delivery variant, each topology cross-checked (dumps, cycles, link
    traversals) between the spec engine and ``TorchEngine``."""
    from hpa2_tpu_torch.analysis.topology import (
        VARIANTS, storm_run, storm_traces)
    from hpa2_tpu_torch.config import InterconnectConfig, SystemConfig
    from hpa2_tpu_torch.models.spec_engine import SpecEngine
    from hpa2_tpu_torch.ops.engine import TorchEngine

    dev = resolve_device(device)
    nodes = _env_int("HPA2_TOPO_NODES", 8)
    rounds = _env_int("HPA2_TOPO_ROUNDS", 6)
    bandwidth = _env_int("HPA2_TOPO_BANDWIDTH", 1)
    base_cfg = SystemConfig(num_procs=nodes, max_instr_num=0)
    traces = storm_traces(base_cfg, rounds)
    ideal_cycles, _, _ = storm_run(base_cfg, traces)

    def _cross_check(cfg) -> bool:
        sp = SpecEngine(cfg, [list(t) for t in traces])
        sp.run()
        tx = TorchEngine(cfg, [list(t) for t in traces], device=dev).run()
        return (
            _final_dicts(sp) == _final_dicts(tx)
            and sp.cycle == tx.cycle
            and sp.link_stats()["traversals"]
            == tx.link_stats()["traversals"]
        )

    topos = {}
    agree = True
    for topo in ("mesh2d", "torus2d", "hierarchical"):
        rows = {}
        for vname, kw in VARIANTS:
            cfg = dataclasses.replace(
                base_cfg,
                interconnect=InterconnectConfig(
                    topology=topo, link_bandwidth=bandwidth, **kw),
            )
            cycles, stats, link = storm_run(cfg, traces)
            rows[vname] = {
                "cycles": cycles,
                "slowdown_over_ideal": round(cycles / ideal_cycles, 3),
                "topo_delay_cycles": stats.get("topo_delay_cycles", 0),
                "topo_multicast_saved": stats.get(
                    "topo_multicast_saved", 0),
                "topo_combined": stats.get("topo_combined", 0),
                "links": link,
            }
        ok = _cross_check(dataclasses.replace(
            base_cfg,
            interconnect=InterconnectConfig(topology=topo,
                                            link_bandwidth=bandwidth),
        ))
        agree = agree and ok
        rows["spec_jax_agree"] = ok
        topos[topo] = rows

    on_card = dev.type == "cuda"
    return {
        "metric": "invalidation_storm_slowdown_mesh2d_unicast",
        "value": topos["mesh2d"]["unicast"]["slowdown_over_ideal"],
        "unit": "x ideal cycles",
        "platform": "gpu" if on_card else "cpu",
        "indicative": on_card,
        "nodes": nodes,
        "storm_rounds": rounds,
        "link_bandwidth": bandwidth,
        "ideal_cycles": ideal_cycles,
        "spec_jax_agree_all": agree,
        "topologies": topos,
    }


def protocol_main(device: str = "cuda") -> dict:
    """``bench.py --protocol`` (``protocol_main``, l.1148-1268): run
    cycles and coherence counters of MESI, MOESI and MESIF on a
    sharing-heavy workload, and of the full, limited and coarse
    directories on a wide geometry, each row's dumps and cycles
    cross-checked between the spec engine and ``TorchEngine``."""
    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.models.protocol import Instr
    from hpa2_tpu_torch.models.spec_engine import SpecEngine
    from hpa2_tpu_torch.ops.engine import TorchEngine
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    dev = resolve_device(device)
    nodes = _env_int("HPA2_PROTO_NODES", 8)
    instrs = _env_int("HPA2_PROTO_INSTRS", 48)
    batch = _env_int("HPA2_PROTO_BATCH", 4)
    wide_nodes = _env_int("HPA2_PROTO_WIDE_NODES", 18)

    def _traces_for(cfg, seed):
        """Uniform random folded onto the first three homes, so lines
        are contended (where the protocols differ)."""
        op, addr, val, _ = gen_uniform_random_arrays(cfg, batch, instrs,
                                                     seed=seed)
        addr = addr % (3 * cfg.mem_size)
        return [
            [
                [Instr("W", int(a), int(v)) if o == 1 else Instr("R", int(a))
                 for o, a, v in zip(op[b, m], addr[b, m], val[b, m])]
                for m in range(cfg.num_procs)
            ]
            for b in range(batch)
        ]

    keys = ("msgs_total", "invalidations", "forwards", "owner_transfers",
            "dir_overflows", "evictions")

    def _ab_row(cfg, seed):
        totals = {"cycles": 0}
        agree = True
        for traces in _traces_for(cfg, seed):
            sp = SpecEngine(cfg, traces)
            sp.run(max_cycles=200_000)
            st = sp.stats()
            totals["cycles"] += sp.cycle
            for k in keys:
                totals[k] = totals.get(k, 0) + st.get(k, 0)
            tx = TorchEngine(cfg, traces, max_cycles=200_000,
                             device=dev).run()
            agree = agree and (_final_dicts(sp) == _final_dicts(tx)
                               and sp.cycle == tx.cycle)
        totals["spec_jax_agree"] = agree
        return totals

    sem = Semantics().robust()
    protocols = {
        protocol: _ab_row(SystemConfig(num_procs=nodes, semantics=sem,
                                       protocol=protocol), seed=13)
        for protocol in ("mesi", "moesi", "mesif")
    }
    formats = {
        fmt: _ab_row(SystemConfig(num_procs=wide_nodes, cache_size=2,
                                  mem_size=8, msg_buffer_size=256,
                                  semantics=sem, directory_format=fmt),
                     seed=9)
        for fmt in ("full", "limited:2", "coarse:4")
    }
    agree = all(r["spec_jax_agree"]
                for r in list(protocols.values()) + list(formats.values()))
    on_card = dev.type == "cuda"
    return {
        "metric": "protocol_traffic_ratio_moesi_over_mesi",
        "value": round(protocols["moesi"]["msgs_total"]
                       / max(protocols["mesi"]["msgs_total"], 1), 4),
        "unit": "x MESI msgs on the shared-hot workload",
        "platform": "gpu" if on_card else "cpu",
        "indicative": on_card,
        "nodes": nodes,
        "wide_nodes": wide_nodes,
        "instrs_per_core": instrs,
        "batch": batch,
        "spec_jax_agree_all": agree,
        "protocols": protocols,
        "directory_formats": formats,
    }


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

_USAGE = (
    "usage: python -m hpa2_tpu_torch.bench [--device cuda|cpu] "
    "[--serve|--failover|--topology|--protocol] "
    "[--trace-len-dist uniform|zipf] [--trace-len-spread R] "
    "[--schedule-resident N] [--host-barriers] [--packed] [--no-elide] "
    "[--data-shards N] [--node-shards N] "
    "[--exchange-mode pairwise|a2a|butterfly|hier]"
)


def _flag_value(argv: List[str], flag: str) -> Optional[str]:
    i = argv.index(flag)
    if i + 1 >= len(argv):
        raise SystemExit(f"{flag} needs a value\n{_USAGE}")
    return argv[i + 1]


def main(argv: Optional[List[str]] = None) -> int:
    """Parse ``bench.py``'s flags into its environment knobs, run the
    study asked for and print its JSON line."""
    argv = list(sys.argv[1:] if argv is None else argv)
    for flag, env in (("--data-shards", "HPA2_BENCH_DATA_SHARDS"),
                      ("--node-shards", "HPA2_BENCH_NODE_SHARDS")):
        if flag in argv:
            try:
                os.environ[env] = str(int(_flag_value(argv, flag)))
            except ValueError:
                raise SystemExit(_USAGE)
    if "--exchange-mode" in argv:
        mode = _flag_value(argv, "--exchange-mode")
        if mode not in ("pairwise", "a2a", "butterfly", "hier"):
            raise SystemExit(_USAGE)
        os.environ["HPA2_BENCH_EXCHANGE_MODE"] = mode
    device = _flag_value(argv, "--device") if "--device" in argv else "cuda"
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"--device takes cuda or cpu\n{_USAGE}")
    if "--trace-len-dist" in argv:
        dist = _flag_value(argv, "--trace-len-dist")
        if dist not in ("uniform", "zipf"):
            raise SystemExit(_USAGE)
        os.environ["HPA2_BENCH_TRACE_DIST"] = dist
    for flag, env, conv in (
            ("--trace-len-spread", "HPA2_BENCH_TRACE_SPREAD", float),
            ("--schedule-resident", "HPA2_BENCH_SCHEDULE_RESIDENT", int)):
        if flag in argv:
            try:
                os.environ[env] = str(conv(_flag_value(argv, flag)))
            except ValueError:
                raise SystemExit(_USAGE)
    for flag, env in (("--packed", "HPA2_BENCH_PACKED"),
                      ("--no-elide", "HPA2_BENCH_NO_ELIDE"),
                      ("--host-barriers", "HPA2_BENCH_HOST_BARRIERS")):
        if flag in argv:
            os.environ[env] = "1"
    study = headline_main
    for flag, fn in (("--serve", serve_main), ("--failover", failover_main),
                     ("--topology", topo_main),
                     ("--protocol", protocol_main)):
        if flag in argv:
            study = fn
            break
    print(json.dumps(study(device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
