"""K1's node-sharded cycle as kernels (``csrc/node_cycle.cu``, N1-N4),
on the CPU: their ``__host__ __device__`` bodies built with g++
(``tests/torch_node_host.py``) run a node-sharded engine's every launch,
each held against its plain version on the same inputs
(``NodeCycle.check``), and the run's planes against the one-card run's:
8 nodes over 2 logical ranks (``make_mesh(..., local=True)``), 22 nodes
(split sharer planes), 12 nodes packed, and over 4 gloo ranks every
exchange schedule and a tight ``exchange_slots`` (N2's overflow).  Also
``parallel/comm.py:LocalComm``'s collectives against gloo's on the
exchange's cases, and the kernels' bounds."""

import ctypes
import dataclasses
import functools

import numpy as np
import pytest
import torch

import torch_node_host
from hpa2_tpu_torch.config import Semantics, SystemConfig
from hpa2_tpu_torch.models.spec_engine import StallError
from hpa2_tpu_torch.ops import node_cycle
from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
from hpa2_tpu_torch.parallel import NodeShardedCudaEngine, make_mesh
from hpa2_tpu_torch.parallel.launch import LocalPool, spawn
from hpa2_tpu_torch.parallel.sharding import run_node_sharded
from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays
from torch_ranks import FSTATS, exchange_rank
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KINDS = ("node_ab", "node_bucket", "node_deliver", "node_settle")


@pytest.fixture(scope="module")
def host():
    lib = torch_node_host.build()
    if lib is None:
        pytest.skip("g++ is not installed")
    return lib


def _cfg(n, mode="a2a", cap=16):
    return SystemConfig(num_procs=n, msg_buffer_size=cap,
                        semantics=Semantics().robust(), exchange_mode=mode)


@functools.lru_cache(maxsize=None)
def _reference(n, b, t, packed=False, snapshots=True, window=None):
    """The one-card run (plain versions) of the same arrays."""
    cfg = _cfg(n)
    arrays = gen_uniform_random_arrays(cfg, b, t, seed=n)
    kw = {} if window is None else {"trace_window": window}
    return arrays, CudaEngine(cfg, *arrays, block=b, cycles_per_call=16,
                              packed=packed, snapshots=snapshots,
                              device="cpu", **kw).run()


def _held(eng, calls):
    """Every rank launched each kernel and held each launch against its
    plain version (max_abs_err 0)."""
    for st in eng.rank_stats:
        assert st["calls"] == calls
        for kind in KINDS:
            launches = st["launches"][kind]
            assert launches >= 16 * calls, (kind, st["launches"])
            assert st["checked"][kind] == [launches, 0], kind


def test_host_args_sizes_match_mirrors(host):
    assert host.hpa2_node_args_size() == ctypes.sizeof(node_cycle.NodeArgs)
    assert host.hpa2_bucket_args_size() == ctypes.sizeof(
        node_cycle.BucketArgs)


#: logical-rank cases: (nodes, systems, instructions, packed, snapshots,
#: trace window, exchange mode)
LOCAL = {
    "8 nodes a2a": (8, 4, 12, False, True, None, "a2a"),
    "8 nodes windowed pairwise": (8, 4, 12, False, False, 4, "pairwise"),
    "16 nodes": (16, 4, 8, False, True, None, "a2a"),
    "22 nodes split": (22, 2, 8, False, True, None, "a2a"),
    "12 nodes packed": (12, 4, 8, True, False, None, "a2a"),
}


@pytest.mark.parametrize("case", list(LOCAL))
def test_host_kernels_match_plain_over_logical_ranks(host, monkeypatch,
                                                     case):
    """Two logical ranks on the CPU, every node-kernel launch run by the
    host build and held against its plain version; the gathered planes
    equal the one-card run's, bit for bit."""
    n, b, t, packed, snapshots, window, mode = LOCAL[case]
    launcher = torch_node_host.HostLauncher(host)
    monkeypatch.setattr(node_cycle, "HOST_LAUNCHER", launcher)
    arrays, ref = _reference(n, b, t, packed, snapshots, window)
    kw = {} if window is None else {"trace_window": window}
    eng = NodeShardedCudaEngine(
        _cfg(n, mode), *arrays,
        mesh=make_mesh(node_shards=2, device="cpu", local=True), block=b,
        cycles_per_call=16, packed=packed, snapshots=snapshots,
        _check_calls=1_000, **kw).run()
    for f, v in ref.state.items():
        assert torch.equal(v, eng.state[f]), f
    assert eng.cycle == ref.cycle
    _held(eng, eng.rank_stats[0]["calls"])
    assert sum(launcher.launches.values()) == sum(
        sum(st["launches"].values()) for st in eng.rank_stats)


MODES = ("pairwise", "a2a", "butterfly", "hier")


@functools.lru_cache(maxsize=None)
def _gloo_runs():
    """Every schedule over 4 gloo ranks, and tight exchange buffers at 4
    and 2 ranks, in one spawned group each, the node kernels run by
    their host build on every rank."""
    arrays, _ = _reference(8, 4, 12)
    runs = {m: NodeShardedCudaEngine(
        _cfg(8, m), *arrays, mesh=make_mesh(node_shards=4, device="cpu"),
        block=4, cycles_per_call=16, _check_calls=1_000) for m in MODES}
    runs["tight a2a"] = NodeShardedCudaEngine(
        _cfg(8), *arrays, mesh=make_mesh(node_shards=4, device="cpu"),
        block=4, cycles_per_call=16, exchange_slots=1, _check_calls=1_000)
    errors = {}
    try:
        run_node_sharded([torch_node_host.HostRun(e) for e in runs.values()])
    except StallError as e:
        errors["4"] = str(e)
    tight2 = NodeShardedCudaEngine(
        _cfg(8, "pairwise"), *arrays,
        mesh=make_mesh(node_shards=2, device="cpu"), block=4,
        cycles_per_call=16, exchange_slots=2, _check_calls=1_000)
    try:
        run_node_sharded([torch_node_host.HostRun(tight2)])
    except StallError as e:
        errors["2"] = str(e)
    runs["tight pairwise 2 ranks"] = tight2
    return runs, errors


@pytest.mark.parametrize("mode", MODES)
def test_host_kernels_every_schedule_over_gloo_ranks(host, mode):
    """N2 under each schedule (one launch for all peers under a2a and
    butterfly, one a round under pairwise and hier, hier's combining
    count among the stats): every launch equal to its plain version, and
    the planes equal to the one-card run's."""
    runs, _ = _gloo_runs()
    _, ref = _reference(8, 4, 12)
    eng = runs[mode]
    for f, v in ref.state.items():
        assert torch.equal(v, eng.state[f]), f
    _held(eng, eng.rank_stats[0]["calls"])
    rounds = {"pairwise": 3, "a2a": 1, "butterfly": 1, "hier": 2}[mode]
    st = eng.rank_stats[0]
    assert st["launches"]["node_bucket"] == rounds * st["launches"]["node_ab"]


@pytest.mark.parametrize("name", ["tight a2a", "tight pairwise 2 ranks"])
def test_host_kernels_tight_exchange_slots_overflow(host, name):
    """A buffer of 1 or 2 slots overflows: N2's overflow count and
    worst-overflow word equal the plain version's on every launch, and
    the run fails loudly naming the demand."""
    runs, errors = _gloo_runs()
    eng = runs[name]
    assert "exchange overflow" in errors["4" if "2 ranks" not in name
                                         else "2"]
    st = eng.rank_stats[0]
    assert st["checked"]["node_bucket"][1] == 0
    assert st["checked"]["node_bucket"][0] == st["launches"]["node_bucket"]
    assert int(eng.state["exchov"].max()) >= 1
    assert int(eng.state["exchdg"].max()) >> 16 > 1


def _payloads(d, seed, r=8, j=6, t=2):
    rng = np.random.default_rng(seed)
    p = rng.integers(-2**31, 2**31, (d, r, j, t), dtype=np.int64
                     ).astype(np.int32)
    p[:, 2] = rng.integers(0, 1 << d, (d, j, t))   # destination set
    p[:, 3] = rng.integers(0, 4, (d, j, t))        # fan count
    p[:, 4] = rng.integers(0, 9, (d, j, t))        # combining key
    return p


def _all_reduce_rank(xs, size=None):
    import torch.distributed as dist

    from hpa2_tpu_torch.parallel.comm import COLLECTIVES, world_comm

    comm, _ = world_comm(size or dist.get_world_size())
    x = torch.from_numpy(xs[comm.rank])
    before = COLLECTIVES.snapshot()
    out = [comm.all_reduce(x, op, world=w).numpy()
           for op in ("sum", "max", "min") for w in (False, True)]
    after = COLLECTIVES.snapshot()
    return out, {f: after[f] - before[f] for f in after}


@pytest.mark.parametrize("d", [2, 4])
def test_local_comm_collectives_equal_gloo(d):
    """``LocalComm`` (threads of this process) against NodeComm on gloo
    ranks: ``exchange.forward``/``feedback`` in every schedule
    (capacity-exact and tight buffers) give the same received blocks,
    origins, feedback, telemetry and collective counts; and the three
    reductions, over the group and the world, the same values."""
    cases = []
    for i, mode in enumerate(MODES):
        if mode == "butterfly" and d & (d - 1):
            continue
        for k in (6, 2):
            cases.append((mode, 2 if mode == "hier" and d == 4 else 0, k,
                          _payloads(d, 10 * d + i)))
    xs = np.random.default_rng(d).integers(-99, 99, (d, 3, 5)).astype(
        np.int32)
    gloo = spawn(exchange_rank, d, args=(cases,), device="cpu")
    gloo_red = spawn(_all_reduce_rank, d, args=(xs,), device="cpu")
    with LocalPool(d, device="cpu") as pool:
        local = pool.run(exchange_rank, (cases, d))
        local_red = pool.run(_all_reduce_rank, (xs, d))
    for r in range(d):
        for c in range(len(cases)):
            want, got = gloo[r][c], local[r][c]
            np.testing.assert_array_equal(got["bufs"], want["bufs"])
            assert got["origins"] == want["origins"]
            np.testing.assert_array_equal(got["acc"], want["acc"])
            np.testing.assert_array_equal(got["fs"], want["fs"])
            assert got["collectives"] == want["collectives"]
        for a, b in zip(local_red[r][0], gloo_red[r][0]):
            np.testing.assert_array_equal(a, b)
        assert local_red[r][1] == gloo_red[r][1] == dict(
            ppermute=0, all_to_all=0, sum=2, max=2, min=2)
    assert len(FSTATS) == 6


def _boom(env):
    from hpa2_tpu_torch.parallel.comm import world_comm

    comm, _ = world_comm(2)
    if comm.rank == 1:
        raise RuntimeError("logical rank says no")
    comm.all_reduce(torch.zeros(1), "sum")


def test_local_pool_failure_raises_without_hanging():
    """A logical rank's exception breaks its group's barrier, so the
    rank waiting in a collective stops too, and the caller sees the
    first rank's own error."""
    pool = LocalPool(2, device="cpu")
    with pytest.raises(RuntimeError, match="logical rank says no"):
        pool.call(_boom)
    assert pool.closed


def test_node_kernel_bounds_and_cycle_names():
    """The kernels take any width the node axis does (64 nodes on the
    register instantiations, 128 and 4,096 on the wide family) and at
    most 16 shards (the path then raises unless cycle="tensor" is
    named); an unknown cycle name raises; a local mesh needs no card."""
    node_cycle.check_node_kernel_bound(_cfg(64), 16)
    node_cycle.check_node_kernel_bound(
        dataclasses.replace(_cfg(64), num_procs=128), 2)
    node_cycle.check_node_kernel_bound(
        dataclasses.replace(_cfg(64), num_procs=4096), 4)
    with pytest.raises(ValueError, match="cycle='tensor'"):
        node_cycle.check_node_kernel_bound(_cfg(64), 32)
    with pytest.raises(ValueError, match="16"):
        node_cycle.check_node_kernel_bound(_cfg(64), 32)
    mesh = make_mesh(node_shards=4, device="cpu", local=True)
    assert (mesh.node, mesh.data, mesh.local) == (4, 1, True)
    arrays, _ = _reference(8, 4, 12)
    with pytest.raises(ValueError, match="cycle="):
        NodeShardedCudaEngine(
            _cfg(8), *arrays, mesh=make_mesh(node_shards=2, device="cpu",
                                             local=True),
            block=4, cycle="bogus")


def _kept_stage_bytes(eng):
    """On a logical rank: one 16-cycle call of the node cycle with the
    inputs of every stage at cycle 2 kept; each stage's bound bytes
    (``NodeCycle._stage_bytes``) beside the bytes of its kept inputs
    and of its outputs in full."""
    from hpa2_tpu_torch.ops.cycle import TRANSIENTS
    from hpa2_tpu_torch.ops.layout import _init_state
    from hpa2_tpu_torch.parallel.comm import world_comm
    from hpa2_tpu_torch.parallel.sharding import NodeInterval, _node_local

    cfg = eng.config
    comm, _ = world_comm(eng.mesh.node)
    nl = cfg.num_procs // comm.size
    node = slice(comm.rank * nl, (comm.rank + 1) * nl)
    tr = eng._tr_full[node][:, :eng._window].contiguous()
    tl = eng._tr_len_full[node].clamp(max=eng._window).contiguous()
    b = tr.shape[-1]
    prog = NodeInterval(cfg, comm, False, eng._window, 16, 1,
                        packed=eng._packed)
    nc = prog.cycle
    nc.keep_at = 2
    st = _node_local(_init_state(cfg, b, False, eng._packed), comm.rank, nl,
                     slice(None), torch.device("cpu"))
    prog(st, {f: torch.zeros((1, b), dtype=torch.int32) for f in TRANSIENTS},
         tr, tl)

    def size(x):
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        if isinstance(x, dict):
            return sum(size(v) for f, v in x.items() if f != "tr")
        if isinstance(x, (list, tuple)):
            return sum(size(v) for v in x)
        return 0

    out = {}
    for name, kept in nc.kept.items():
        if name == "node_bucket":
            _, _, blocks, dests, k, _, _ = kept
            full = sum(d.compact for d in dests) * (
                nc.R * k * b * 4 + max(x.shape[1] for x in blocks) * b * 8)
        elif name == "node_deliver":
            full = (1 + nc.SW) * sum(x.shape[1] for x in kept[1]) * b * 4
        else:
            full = (nc.R * 5 * nl + node_cycle.AB_COUNTS
                    + node_cycle.SUM_ROWS + node_cycle.MAX_ROWS) * b * 4
        out[name] = (nc._stage_bytes(name, kept), 2 * size(kept) + full)
    return out


@pytest.mark.parametrize("case", ["8 nodes hier", "12 nodes packed",
                                  "22 nodes split"])
def test_stage_bytes_count_what_the_stages_move(case):
    """The bytes the kernels line bounds N1-N4 by: every stage of a kept
    cycle counts some bytes, and fewer than its kept inputs read and
    written in full plus its outputs."""
    n, mode, packed = {"8 nodes hier": (8, "hier", False),
                       "12 nodes packed": (12, "a2a", True),
                       "22 nodes split": (22, "a2a", False)}[case]
    arrays, _ = _reference(n, 4, 12 if n == 8 else 8, packed, False)
    eng = NodeShardedCudaEngine(
        _cfg(n, mode), *arrays,
        mesh=make_mesh(node_shards=2, device="cpu", local=True), block=4,
        cycles_per_call=16, packed=packed, snapshots=False)
    with LocalPool(2, device="cpu") as pool:
        rows = pool.run(_kept_stage_bytes, (eng,))
    for row in rows:
        assert sorted(row) == sorted(KINDS)
        for name, (got, full) in row.items():
            assert 0 < got < full, (name, got, full)
