"""The CUDA kernels on the card against their plain PyTorch versions
(every node bound: 8, 21 and 64 with split sharer planes, and packed
planes): the streamed run, and the per-call kernel under its host
loop; lane blocks above 1,024 lanes up to the card's bound; the
engine's ``run`` on the card against the CPU, unscheduled and
scheduled; serving on the card against the CPU, pipelined and serial;
the five op-pattern micro-kernels; and the general engine on the card
against the CPU and K2 (its batch loop, a replayed system, a faulty
mesh under MOESI), and its severed-edge stall.  These need an
NVIDIA GPU with nvcc (sm_90a) and skip elsewhere; on the card run them
with

    python -m pytest tests/test_torch_card.py -m cuda
"""

import numpy as np
import pytest
import torch

from hpa2_tpu_torch.config import Semantics, SystemConfig
from hpa2_tpu_torch.convert import state_from_numpy
from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.ops.call_run import run_windows
from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
from hpa2_tpu_torch.ops.layout import _init_state, _pack_traces, fields_of
from hpa2_tpu_torch.ops.schedule import Schedule
from hpa2_tpu_torch.ops.stream_run import stream_run_plain
from hpa2_tpu_torch.scripts import micro_kernels
from hpa2_tpu_torch.serving import ListJobSource, serve, synthetic_jobs
from hpa2_tpu_torch.utils.trace import (
    gen_heterogeneous_random_arrays, gen_uniform_random_arrays,
)

pytestmark = pytest.mark.cuda


def _same(x, y):
    """Bit-equal planes of any type and device (u16 has few ops on the
    card, so the comparison is made in numpy)."""
    return np.array_equal(x.cpu().numpy(), y.cpu().numpy())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "n,cap,robust,window,t,gate,snapshots,geom,packed",
    [(8, 16, True, 8, 24, True, False, None, False),
     (4, 32, True, 16, 16, False, True, None, False),
     (4, 16, False, 12, 12, True, True, None, False),
     (4, 16, True, 16, 16, True, True, (2, 8), True),
     (8, 16, True, 8, 24, True, False, None, True),
     (22, 16, True, 5, 12, True, True, (2, 4), False),
     (22, 16, True, 5, 12, False, False, (2, 4), True),
     (33, 32, True, 10, 10, True, True, (4, 8), False),
     (64, 16, True, 8, 8, True, False, (4, 16), False)],
)
def test_kernel_matches_plain_on_card(card, n, cap, robust, window, t, gate,
                                      snapshots, geom, packed):
    sem = Semantics().robust() if robust else Semantics()
    c, m = geom or (4, 16)
    cfg = SystemConfig(num_procs=n, msg_buffer_size=cap, semantics=sem,
                       cache_size=c, mem_size=m)
    b = 64
    op, addr, val, length = gen_uniform_random_arrays(cfg, b, t, seed=n)
    n_seg = -(-t // window)
    tr = np.pad(_pack_traces(cfg, op, addr, val, length),
                ((0, 0), (0, n_seg * window - t), (0, 0)))
    tr = torch.from_numpy(tr).to(card)
    tr_len = torch.from_numpy(np.ascontiguousarray(length.T)).to(card)
    state = state_from_numpy(_init_state(cfg, b, snapshots, packed), card)
    kw = dict(block=16, k=32, window=window, n_seg=n_seg,
              max_calls=100 if robust else 4, gate=gate,
              snapshots=snapshots, packed=packed)
    got = {f: v.clone() for f, v in state.items()}
    before = kernels.STREAM_RUN.launches
    status = kernels.stream_run(cfg, got, tr, tr_len, **kw)
    want, want_status = stream_run_plain(cfg, state, tr, tr_len, **kw)
    torch.cuda.synchronize()
    assert kernels.STREAM_RUN.launches == before + 1
    assert torch.equal(status, want_status)
    for f in fields_of(cfg, snapshots, packed):
        assert _same(got[f], want[f]), f


@pytest.mark.parametrize("n,c,m,packed", [(8, 4, 16, False),
                                         (33, 2, 4, True)])
def test_engine_on_card_matches_cpu(card, n, c, m, packed):
    cfg = SystemConfig(num_procs=n, msg_buffer_size=16, cache_size=c,
                       mem_size=m, semantics=Semantics().robust())
    arrays = gen_uniform_random_arrays(cfg, 32, 40, seed=2)
    kw = dict(block=8, cycles_per_call=32, snapshots=False, trace_window=16,
              packed=packed)
    on_card = CudaEngine(cfg, *arrays, **kw).run()
    on_cpu = CudaEngine(cfg, *arrays, device="cpu", **kw).run()
    assert on_card.device.type == "cuda"
    for f, v in on_cpu.state.items():
        assert _same(on_card.state[f], v), f
    assert on_card.stats() == on_cpu.stats()


def test_wider_than_kernel_bound_refused_on_card(card):
    cfg = SystemConfig(num_procs=65, msg_buffer_size=16,
                       semantics=Semantics().robust())
    arrays = gen_uniform_random_arrays(cfg, 2, 2, seed=0)
    with pytest.raises(ValueError, match="node bound of 64"):
        CudaEngine(cfg, *arrays, block=2)


@pytest.mark.parametrize(
    "n,cap,robust,window,t,gate,snapshots,geom,packed",
    [(8, 16, True, 7, 20, False, False, None, False),
     (8, 16, True, 8, 24, True, False, None, False),
     (4, 16, True, 16, 16, True, True, None, False),
     (8, 4, True, 8, 16, True, False, None, False),    # may stall: short
     (8, 16, True, 8, 24, True, False, None, True),
     (22, 16, True, 5, 12, True, True, (2, 4), False),
     (33, 32, True, 10, 10, False, False, (4, 8), True)],
)
def test_call_kernel_matches_plain_on_card(card, n, cap, robust, window, t,
                                           gate, snapshots, geom, packed):
    """The per-call kernel under its host loop on the card against the
    same loop over the plain version on the CPU: planes and status."""
    sem = Semantics().robust() if robust else Semantics()
    c, m = geom or (4, 16)
    cfg = SystemConfig(num_procs=n, msg_buffer_size=cap, semantics=sem,
                       cache_size=c, mem_size=m)
    b = 64
    op, addr, val, length = gen_uniform_random_arrays(cfg, b, t, seed=n + 1)
    n_seg = -(-t // window)
    tr = torch.from_numpy(np.pad(_pack_traces(cfg, op, addr, val, length),
                                 ((0, 0), (0, n_seg * window - t), (0, 0))))
    tr_len = torch.from_numpy(np.ascontiguousarray(length.T))
    state = state_from_numpy(_init_state(cfg, b, snapshots, packed), "cpu")
    kw = dict(block=16, k=16, window=window, n_seg=n_seg,
              max_calls=100 if cap > 4 else 4, gate=gate,
              snapshots=snapshots, packed=packed)
    got = {f: v.to(card) for f, v in state.items()}
    before = kernels.CALL_RUN.launches
    status = run_windows(cfg, got, tr.to(card), tr_len.to(card), **kw)
    launched = kernels.CALL_RUN.launches - before
    want = {f: v.clone() for f, v in state.items()}
    want_status = run_windows(cfg, want, tr, tr_len, **kw)
    torch.cuda.synchronize()
    assert launched > 0
    assert int(status) == int(want_status)
    for f in fields_of(cfg, snapshots, packed):
        assert _same(got[f], want[f]), f


@pytest.mark.parametrize(
    "n,stream,cap,snapshots,max_calls,block",
    [(8, True, 16, True, 100, 512),    # 2 CTAs a block, CTA 0 idle
     (8, False, 16, True, 100, 1024),  # 4 CTAs a block
     (8, True, 4, False, 2, 512),      # every busy block stalls
     (8, False, 4, True, 2, 512),
     (22, True, 16, True, 100, 256),   # a cluster of 8 CTAs
     (22, True, 16, True, 100, 1024)],  # 16 CTAs of two rounds
)
def test_multi_cta_block_matches_plain_on_card(card, n, stream, cap,
                                               snapshots, max_calls, block):
    """Lane blocks spread over several CTAs of a cluster, the first CTA
    of each block idle from the start (it runs while its block's gate is
    open, and takes its snapshots then), against the plain version:
    planes and the stall status."""
    c, m = (4, 16) if n <= 8 else (2, 4)
    cfg = SystemConfig(num_procs=n, msg_buffer_size=cap, cache_size=c,
                       mem_size=m, semantics=Semantics().robust())
    b, t, window = 2048, 30, 12
    op, addr, val, length = gen_uniform_random_arrays(cfg, b, t, seed=cap)
    per_cta = kernels.launch_geometry(
        block, kernels.threads_per_system(cfg))[1]
    length.reshape(b // block, block, -1)[:, :per_cta] = 0
    n_seg = -(-t // window)
    tr = torch.from_numpy(np.pad(_pack_traces(cfg, op, addr, val, length),
                                 ((0, 0), (0, n_seg * window - t), (0, 0))))
    tr_len = torch.from_numpy(np.ascontiguousarray(length.T))
    state = state_from_numpy(_init_state(cfg, b, snapshots), "cpu")
    kw = dict(block=block, k=16, window=window, n_seg=n_seg,
              max_calls=max_calls, gate=True, snapshots=snapshots)
    got = {f: v.to(card) for f, v in state.items()}
    want = {f: v.clone() for f, v in state.items()}
    if stream:
        status = kernels.stream_run(cfg, got, tr.to(card), tr_len.to(card),
                                    **kw)
        new, want_status = stream_run_plain(cfg, state, tr, tr_len, **kw)
        want.update(new)
        stalled = bool(status.any())
        assert torch.equal(status.cpu(), want_status)
    else:
        status = run_windows(cfg, got, tr.to(card), tr_len.to(card), **kw)
        want_status = run_windows(cfg, want, tr, tr_len, **kw)
        stalled = bool(int(status) & 1)
        assert int(status) == int(want_status)
    torch.cuda.synchronize()
    assert stalled == (cap == 4)
    for f in fields_of(cfg, snapshots):
        assert _same(got[f], want[f]), f
    if snapshots and cap != 4:
        idle = got["snap_taken"].reshape(n, -1, block)[:, :, :per_cta]
        assert bool(idle.all())


@pytest.mark.parametrize("n,c,m,rounds", [(8, 4, 16, 1), (8, 4, 16, 5),
                                         (64, 2, 4, 18)])
def test_block_above_1024_matches_plain_on_card(card, n, c, m, rounds):
    """Lane blocks of one cluster of 16 full CTAs in ``rounds`` rounds:
    2,048 lanes a block at 8 nodes (beside 4,096 more in two blocks),
    and the card's largest blocks at 8 and 64 nodes
    (``kernels.MAX_LANE_BLOCK``), against the plain version."""
    cfg = SystemConfig(num_procs=n, msg_buffer_size=16, cache_size=c,
                       mem_size=m, semantics=Semantics().robust())
    threads = kernels.threads_per_system(cfg)
    block = kernels.MAX_CLUSTER * (kernels.MAX_CTA // threads) * rounds
    if rounds > 1:
        assert block == kernels.MAX_LANE_BLOCK[kernels.node_bound(cfg)]
    block = block if rounds > 1 else 2048
    b, t = (3 * block if rounds == 1 else block), (12 if n <= 8 else 3)
    op, addr, val, length = gen_uniform_random_arrays(cfg, b, t, seed=rounds)
    tr = torch.from_numpy(_pack_traces(cfg, op, addr, val, length))
    tr_len = torch.from_numpy(np.ascontiguousarray(length.T))
    state = state_from_numpy(_init_state(cfg, b, False), "cpu")
    kw = dict(block=block, k=32, window=t, n_seg=1, max_calls=100,
              gate=True, snapshots=False)
    got = {f: v.to(card) for f, v in state.items()}
    before = kernels.STREAM_RUN.launches
    status = kernels.stream_run(cfg, got, tr.to(card), tr_len.to(card), **kw)
    want, want_status = stream_run_plain(cfg, state, tr, tr_len, **kw)
    torch.cuda.synchronize()
    assert kernels.STREAM_RUN.launches == before + 1
    assert torch.equal(status.cpu(), want_status) and not status.any()
    for f in fields_of(cfg, False):
        assert _same(got[f], want[f]), f
    with pytest.raises(ValueError, match="lane block takes on the card"):
        kernels.check_block(
            cfg, kernels.MAX_LANE_BLOCK[kernels.node_bound(cfg)] + 1)


@pytest.mark.parametrize("overlap", [True, False])
def test_serve_on_card_matches_cpu(card, overlap):
    """``serve`` on the card against ``serve(device="cpu")``: every job's
    dumps and counters, the occupancy dict, and one kernel launch an
    interval; every compile count is 1."""
    cfg = SystemConfig(num_procs=8, msg_buffer_size=16,
                       semantics=Semantics().robust())
    jobs = synthetic_jobs(cfg, 96, 48, seed=4, spread=4.0)
    kw = dict(resident=32, window=8, block=16, overlap=overlap)
    before = kernels.STREAM_RUN.launches
    results, stats = serve(cfg, ListJobSource(jobs), **kw)
    launched = kernels.STREAM_RUN.launches - before
    want, want_stats = serve(cfg, ListJobSource(jobs), device="cpu", **kw)
    assert launched == stats.occupancy["intervals"] > 0
    assert stats.occupancy == want_stats.occupancy
    assert set(stats.compile_counts.values()) == {1}
    assert [r.job_id for r in results] == [r.job_id for r in want]
    for r, w in zip(results, want):
        assert r.dumps == w.dumps and r.counters == w.counters, r.job_id


@pytest.mark.parametrize("stream,fused", [(True, True), (True, False),
                                          (False, True), (False, False)])
def test_scheduled_engine_on_card_matches_cpu(card, stream, fused):
    cfg = SystemConfig(num_procs=8, msg_buffer_size=16,
                       semantics=Semantics().robust())
    arrays = gen_heterogeneous_random_arrays(cfg, 64, 48, dist="zipf",
                                             spread=6.0, seed=3)
    kw = dict(block=8, cycles_per_call=32, snapshots=False, trace_window=8,
              stream=stream, schedule=Schedule(resident=32, fused=fused))
    launches = {k.name: k.launches for k in kernels.KERNELS}
    on_card = CudaEngine(cfg, *arrays, **kw).run()
    used = kernels.STREAM_RUN if stream else kernels.CALL_RUN
    assert used.launches > launches[used.name]
    on_cpu = CudaEngine(cfg, *arrays, device="cpu", **kw).run()
    for f, v in on_cpu.state.items():
        assert _same(on_card.state[f], v), f
    assert on_card.occupancy.as_dict() == on_cpu.occupancy.as_dict()
    assert on_card.stats() == on_cpu.stats()


@pytest.mark.parametrize("name", list(micro_kernels.PATTERNS))
def test_micro_kernel_matches_plain_on_card(card, name):
    """Each op-pattern kernel at the script's size (grid=32, K=256)."""
    mk = micro_kernels
    arrays = {k: torch.from_numpy(v).to(card)
              for k, v in mk.make_arrays(mk.B * 32).items()
              if k in mk.PATTERNS[name]}
    got = {k: v.clone() for k, v in arrays.items()}
    before = mk.LAUNCHES[name]
    mk.micro_run(name, got, iters=mk.K, block=mk.B)
    want = mk.plain(name, arrays, iters=mk.K, block=mk.B)
    torch.cuda.synchronize()
    assert mk.LAUNCHES[name] == before + 1
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("elide", [True, False])
def test_general_engine_on_card_matches_cpu_and_k2(card, elide):
    """The general engine on the card (its loop as captured CUDA graphs)
    against the CPU, every field, and against K2 at MESI/full/ideal:
    dumps, snapshots, counters and the longest system's cycle."""
    from hpa2_tpu_torch.ops.engine import build_batched_run
    from hpa2_tpu_torch.ops.state import init_state_batched

    cfg = SystemConfig(num_procs=8, msg_buffer_size=16, elide=elide,
                       semantics=Semantics().robust())
    arrays = gen_uniform_random_arrays(cfg, 64, 24, seed=5)
    run = build_batched_run(cfg)
    syncs = kernels.HOST_SYNCS.count
    got = run(init_state_batched(cfg, *arrays, device=card))
    assert run.chunks >= 1 and kernels.HOST_SYNCS.count - syncs >= run.chunks
    want = run(init_state_batched(cfg, *arrays, device="cpu"))
    for f, x, y in zip(want._fields, got, want):
        assert _same(x, y), f
    k2 = CudaEngine(cfg, *arrays, block=64).run()
    assert int(got.cycle.max()) == k2.cycle
    for b in range(0, 64, 9):
        st = {f: x[b].cpu().numpy() for f, x in zip(got._fields, got)}
        dumps = k2.system_final_dumps(b)
        for i, d in enumerate(dumps):
            assert d.memory == st["mem"][i].tolist()
            assert d.cache_addr == st["cache_addr"][i].tolist()
            assert d.cache_value == st["cache_val"][i].tolist()
            assert d.cache_state == st["cache_state"][i].tolist()
            assert d.dir_state == st["dir_state"][i].tolist()


def test_general_engine_severed_edge_stalls_on_card(card):
    """A severed edge raises the watchdog's StallDiagnostic on the card
    with every field equal to the CPU's."""
    from hpa2_tpu_torch.config import FaultModel, InterconnectConfig
    from hpa2_tpu_torch.ops.engine import BatchTorchEngine, StallDiagnostic
    from hpa2_tpu_torch.utils.trace import gen_uniform_random

    cfg = SystemConfig(
        num_procs=4, semantics=Semantics().robust(),
        interconnect=InterconnectConfig(fault=FaultModel(
            drop=1.0, edge_sender=1, edge_receiver=0, seed=1)))
    batch = [gen_uniform_random(cfg, 16, seed=s) for s in range(4)]
    diags = []
    for dev in (card, "cpu"):
        with pytest.raises(StallDiagnostic) as ei:
            BatchTorchEngine(cfg, batch, watchdog_cycles=50,
                             device=dev).run()
        diags.append(ei.value)
    for f in ("reason", "cycle", "mailbox_depths", "waiting", "blocked",
              "line_states", "recent_msgs", "invariant_violations",
              "counters"):
        assert getattr(diags[0], f) == getattr(diags[1], f), f


@pytest.mark.parametrize("variant", ["replay", "moesi-mesh2d-faults"])
def test_single_system_general_engine_on_card_matches_cpu(card, variant):
    """``TorchEngine`` (a batch of one) on the card against the CPU: a
    replayed issue order (the lockstep loop without elision), and MOESI
    on a mesh with link faults under elision."""
    from hpa2_tpu_torch.config import FaultModel, InterconnectConfig
    from hpa2_tpu_torch.ops.engine import TorchEngine
    from hpa2_tpu_torch.utils.trace import IssueRecord, gen_uniform_random

    kw = {}
    cfg = SystemConfig(num_procs=4, semantics=Semantics().robust())
    traces = gen_uniform_random(cfg, 16, seed=2)
    if variant == "replay":
        # round-robin over the nodes: an interleaving of the traces
        order = [IssueRecord(n, ins.op, ins.address, ins.value)
                 for step in range(16) for n in range(4)
                 for ins in [traces[n][step]]]
        kw["replay_order"] = order
    else:
        cfg = SystemConfig(
            num_procs=4, semantics=Semantics().robust(), protocol="moesi",
            interconnect=InterconnectConfig(
                topology="mesh2d", multicast=True,
                fault=FaultModel(drop=0.2, duplicate=0.1, seed=4)))
    got = TorchEngine(cfg, traces, device=card, **kw).run()
    want = TorchEngine(cfg, traces, device="cpu", **kw).run()
    for f, x, y in zip(want.state._fields, got.state, want.state):
        assert _same(x, y), f
    assert got.stats() == want.stats()
    assert got.link_stats() == want.link_stats()
