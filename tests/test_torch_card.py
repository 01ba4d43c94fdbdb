"""The CUDA kernels on the card against their plain PyTorch versions
(every node bound: 8, 21 and 64 with split sharer planes, and packed
planes): the streamed run, and the per-call kernel under its host
loop; lane blocks above 1,024 lanes up to the card's bound; the
engine's ``run`` on the card against the CPU, unscheduled and
scheduled; serving on the card against the CPU, pipelined and serial;
the five op-pattern micro-kernels; and the general engine on the card
against the CPU and K2 (its batch loop, a replayed system, a faulty
mesh under MOESI), and its severed-edge stall; its scheduled runs, its
serving backend and a checkpoint of its rows; the streamed run under
the HEAD value quirks, and the bench harness
(``python -m hpa2_tpu_torch.bench``) on the card; the analysis suite's
K3 table prober and its contract census on the card; several GPUs
(``hpa2_tpu_torch.parallel``): the data-sharded fast path over every
card against one card's run, and the general engine's node axis over
NCCL ranks against ``TorchEngine``.  These need an NVIDIA GPU with nvcc
(sm_90a) and skip elsewhere (the multi-card cases below two cards); on
the card run them with

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


@pytest.mark.parametrize("fused", [True, False])
def test_scheduled_general_engine_on_card_matches_cpu(card, fused):
    """``BatchTorchEngine(schedule=...)`` on the card (the host loop's
    chunks are replays of one captured graph and one read each) equals
    the CPU in every field and occupancy counter, with faults."""
    from hpa2_tpu_torch.config import FaultModel, InterconnectConfig
    from hpa2_tpu_torch.convert import sim_state_to_numpy
    from hpa2_tpu_torch.models.protocol import Instr
    from hpa2_tpu_torch.ops.engine import BatchTorchEngine

    cfg = SystemConfig(num_procs=4, semantics=Semantics().robust(),
                       interconnect=InterconnectConfig(fault=FaultModel(
                           drop=0.2, duplicate=0.1, reorder=0.2, seed=7)))
    op, addr, val, length = gen_heterogeneous_random_arrays(
        cfg, 12, 24, dist="zipf", spread=4.0, seed=3)
    batch = [[[Instr("W", int(a), int(v)) if o == 1 else Instr("R", int(a))
               for o, a, v in zip(op[s, i, :length[s, i]],
                                  addr[s, i, :length[s, i]],
                                  val[s, i, :length[s, i]])]
              for i in range(4)] for s in range(12)]
    sched = Schedule(resident=4, interval=64, fused=fused)
    got = BatchTorchEngine(cfg, batch, schedule=sched, device="cuda").run()
    want = BatchTorchEngine(cfg, batch, schedule=sched, device="cpu").run()
    g, w = sim_state_to_numpy(got.state), sim_state_to_numpy(want.state)
    assert [f for f in w if not np.array_equal(g[f], w[f])] == []
    assert got.occupancy.as_dict() == want.occupancy.as_dict()


@pytest.mark.parametrize("window", [None, 8])
def test_serve_jax_on_card_matches_cpu(card, window):
    """``serve(backend="jax")`` on the card: the chunk graph captured
    once on the session's rows, which keep their storage; every job's
    dumps and counters equal the CPU's."""
    cfg = SystemConfig(num_procs=4, semantics=Semantics().robust())
    jobs = synthetic_jobs(cfg, 12, 24, seed=7, spread=3.0)
    kw = dict(backend="jax", resident=4, interval=16, max_trace_len=24,
              jax_window=window)
    from hpa2_tpu_torch.serving import build_serving

    drv = build_serving(cfg, ListJobSource(jobs), device="cuda", **kw)
    ptrs = [x.data_ptr() for x in drv.session.state]
    got, st = drv.run()
    want, _ = serve(cfg, ListJobSource(jobs), device="cpu", **kw)
    assert [x.data_ptr() for x in drv.session.state] == ptrs
    assert set(st.compile_counts.values()) == {1}
    assert drv.session._bound.graphs == 1
    w = {r.job_id: (r.dumps, r.counters) for r in want}
    assert {r.job_id: (r.dumps, r.counters) for r in got} == w


def test_checkpoint_round_trip_on_card(card, tmp_path):
    """Rows of a session on the card, saved mid-run and loaded back on
    the card and on the CPU: every field equal."""
    from hpa2_tpu_torch.ops.engine import BatchLaneSession
    from hpa2_tpu_torch.utils.checkpoint import load_state, save_state

    cfg = SystemConfig(num_procs=4, semantics=Semantics().robust())
    sess = BatchLaneSession(cfg, 4, 24, interval=8, device="cuda")
    for i, job in enumerate(synthetic_jobs(cfg, 4, 24, seed=7)):
        sess.admit(i, sess.fresh_row(job.batch_traces()))
    sess.advance()
    sess.quiescent_rows()
    path = str(tmp_path / "ck.npz")
    save_state(path, sess.state, cfg)
    for dev in ("cuda", "cpu"):
        back, back_cfg = load_state(path, device=dev)
        assert back_cfg == cfg
        assert all(a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
                   for a, b in zip(back, sess.state))


@pytest.mark.parametrize("quirks", [
    dict(eager_write_request_memory=True),
    dict(flush_invack_fills_old_value=True),
    dict(eager_write_request_memory=True, flush_invack_fills_old_value=True),
])
@pytest.mark.parametrize("robust", [True, False])
def test_kernel_with_value_quirks_matches_plain_on_card(card, quirks,
                                                        robust):
    """K2 under the HEAD value quirks (runtime flags of the kernel),
    with the NACK policy (runs complete) and under fixture semantics
    (random traffic stalls at the budget), against the plain version."""
    sem = Semantics(**quirks)
    cfg = SystemConfig(num_procs=8, msg_buffer_size=16,
                       semantics=sem.robust() if robust else sem)
    b, t, window = 256, 32, 8
    op, addr, val, length = gen_uniform_random_arrays(cfg, b, t, seed=3)
    n_seg = -(-t // window)
    tr = torch.from_numpy(_pack_traces(cfg, op, addr, val, length)).to(card)
    tr_len = torch.from_numpy(np.ascontiguousarray(length.T)).to(card)
    state = state_from_numpy(_init_state(cfg, b, False), card)
    kw = dict(block=64, k=32, window=window, n_seg=n_seg,
              max_calls=200 if robust else 8, gate=True, snapshots=False)
    got = {f: v.clone() for f, v in state.items()}
    status = kernels.stream_run(cfg, got, tr, tr_len, **kw)
    want, want_status = stream_run_plain(cfg, state, tr, tr_len, **kw)
    assert _same(status, want_status)
    assert bool(status.any()) != robust
    for f in fields_of(cfg, False):
        assert _same(got[f], want[f]), f


def test_bench_harness_on_card(card):
    """``python -m hpa2_tpu_torch.bench --topology`` and the headline
    exit 0 with ``platform: "gpu"`` and the card's name."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    for extra in (["--topology"], []):
        proc = subprocess.run(
            [sys.executable, "-m", "hpa2_tpu_torch.bench", *extra],
            capture_output=True, text=True, env=env, cwd=str(root),
            timeout=600)
        assert proc.returncode == 0, proc.stderr[-2000:]
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        assert rec["platform"] == "gpu" and rec["indicative"]
        if not extra:
            assert rec["omp_ops_per_sec"] > 0 and rec["vs_baseline"] > 0
            assert rec["device"]["name"] == torch.cuda.get_device_name(0)


@pytest.mark.parametrize("robust", [False, True])
def test_k3_table_prober_on_card(card, robust):
    """The analysis suite's ``pallas`` prober on the card: one K3 launch,
    every probeable MESI row a lane, 0 table diffs, and the launch's
    planes equal to the plain version's on the same staged planes."""
    from hpa2_tpu_torch.analysis import extract
    from hpa2_tpu_torch.analysis.table import build_table
    from hpa2_tpu_torch.ops.call_run import call_plain

    sem = Semantics().robust() if robust else Semantics()
    table = build_table(sem)
    prober = extract.PallasProber(sem, device="cuda")
    launches = kernels.CALL_RUN.launches
    assert extract.diff_backend(table, "pallas", prober=prober) == []
    assert kernels.CALL_RUN.launches == launches + 1
    scns = [extract.scenario_for(r) for r in extract.probeable_rows(table)]
    state, tr, tl = prober.staged(scns)
    want = call_plain(prober.cfg, state, tr, tl, seg=0, block=len(scns),
                      k=1, window=1, gate=False, snapshots=False)
    prober.run(state, tr, tl)
    assert all(_same(state[f], want[f]) for f in want)


def test_contract_census_on_card(card):
    """``contracts`` on the card: the 8 unsharded points and the
    data-sharded one clean with their card rules, the three node-sharded
    points (the fast path's and the general engine's two) clean on four
    cards and skipped on fewer, and the wrappers' calls equal to the
    libraries' launches."""
    from hpa2_tpu_torch.analysis import contracts, ir

    with ir.launch_census() as c:
        results = contracts.run_contracts(device="cuda",
                                          out=lambda line: None)
    # data-sharded-pallas runs on one card named four times; the
    # node-sharded points need four cards (one NCCL rank each)
    four = torch.cuda.device_count() >= 4
    assert sorted(r.status for r in results) == (
        ["ok"] * (12 if four else 9) + ["skip"] * (0 if four else 3))
    assert c["calls.stream_run"] == c["launches.stream_run"] > 0
    assert c["calls.call_run"] == c["launches.call_run"]


@pytest.mark.parametrize("stream", [True, False], ids=["stream", "call"])
@pytest.mark.parametrize("n,stage", [(8, "phase_a"), (12, "deliver"),
                                     (40, "phase_b")])
def test_packed_ablated_engine_on_card_matches_cpu(card, stream, n, stage):
    """The packed ablation instantiations (K1's stubs in K2 and K3 on
    u8/u16 planes) against the plain ablated version, a lane block over
    two CTAs; both stall at the budget."""
    from hpa2_tpu_torch.ops.layout import StallError

    cfg = SystemConfig(num_procs=n, msg_buffer_size=16,
                       semantics=Semantics().robust())
    arrays = gen_uniform_random_arrays(cfg, 64, 16, seed=n)
    kw = dict(block=64, cycles_per_call=8, snapshots=False, trace_window=8,
              stream=stream, packed=True, _ablate=frozenset({stage}))
    engines = []
    for dev in ("cuda", "cpu"):
        eng = CudaEngine(cfg, *arrays, device=dev, **kw)
        with pytest.raises(StallError):
            eng.run(max_cycles=32)
        engines.append(eng)
    for f, v in engines[1].state.items():
        assert _same(engines[0].state[f], v), f


@pytest.fixture
def two_cards(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (one data shard or one NCCL "
                    "rank a card)")
    return torch.cuda.device_count()


@pytest.mark.parametrize("stream,scheduled", [(True, False), (False, False),
                                              (True, True)])
def test_data_sharded_engine_over_cards_matches_one_card(two_cards, stream,
                                                         scheduled):
    """``DataShardedCudaEngine`` over every card equals ``CudaEngine`` on
    one card plane for plane, with one launch a shard (streamed) and one
    status read."""
    from hpa2_tpu_torch.parallel import DataShardedCudaEngine

    cfg = SystemConfig(num_procs=8, msg_buffer_size=16,
                       semantics=Semantics().robust())
    b = 256 * two_cards
    arrays = gen_heterogeneous_random_arrays(cfg, b, 32, dist="zipf",
                                             spread=4.0, seed=3)
    kw = dict(block=64, cycles_per_call=32, snapshots=False,
              trace_window=8, stream=stream,
              schedule=Schedule(resident=b // 2) if scheduled else None)
    ref = CudaEngine(cfg, *arrays, device="cuda", **kw).run()
    eng = DataShardedCudaEngine(cfg, *arrays, device="cuda", **kw)
    assert [d.index for d in eng.mesh.devices] == list(range(two_cards))
    kernels.STREAM_RUN.launches = 0
    syncs = kernels.HOST_SYNCS.count
    eng.run()
    if stream and not scheduled:
        assert kernels.STREAM_RUN.launches == two_cards
        assert kernels.HOST_SYNCS.count - syncs == 1
    got = eng.state
    for f, v in ref.state.items():
        assert _same(got[f], v), f


@pytest.mark.parametrize("mode", ["a2a", "pairwise", "butterfly", "hier"])
def test_node_sharded_engine_over_nccl_matches_torch_engine(two_cards,
                                                           mode):
    """``NodeShardedEngine`` over two NCCL ranks (and four on four cards)
    equals ``TorchEngine`` on the card; a cycle's collectives are the
    plan's plus one SUM and one MAX."""
    from hpa2_tpu_torch.ops.engine import TorchEngine
    from hpa2_tpu_torch.ops.exchange import make_plan, plan_collectives
    from hpa2_tpu_torch.parallel import NodeShardedEngine, make_mesh
    from hpa2_tpu_torch.parallel.sharding import run_node_sharded
    from hpa2_tpu_torch.utils.trace import gen_uniform_random

    cfg = SystemConfig(num_procs=16, msg_buffer_size=16,
                       semantics=Semantics().robust(), exchange_mode=mode)
    traces = gen_uniform_random(cfg, 12, seed=5)
    ref = TorchEngine(cfg, traces, device="cuda").run()
    for node in (2, 4) if two_cards >= 4 else (2,):
        eng = NodeShardedEngine(cfg, traces, mesh=make_mesh(
            node_shards=node, data_shards=1, device="cuda"))
        run_node_sharded([eng])
        assert eng.cycle == ref.cycle
        assert eng.snapshots() == ref.snapshots()
        assert eng.final_dumps() == ref.final_dumps()
        # the elision counters may differ: a rank's watchdog proposal
        # keys on its own issuers (JAX build_node_sharded_run)
        skip = ("exchange", "elided", "multi_hit")
        assert {k: v for k, v in eng.stats().items()
                if not k.startswith(skip)} == {
            k: v for k, v in ref.stats().items() if not k.startswith(skip)}
        want = dict(plan_collectives(make_plan(node, mode)), sum=1, max=1,
                    min=0)
        assert eng.step_collectives == want


@pytest.mark.parametrize("packed", [False, True], ids=["i32", "packed"])
def test_node_sharded_fast_path_over_nccl_matches_k2(two_cards, packed):
    """``NodeShardedCudaEngine`` over two NCCL ranks (and four, and a
    2 x 2 grid, on four cards) equals K2's run on one card plane for
    plane; a cycle's collectives are the plan's plus one SUM and one
    MAX."""
    from hpa2_tpu_torch.ops.exchange import make_plan, plan_collectives
    from hpa2_tpu_torch.parallel import NodeShardedCudaEngine, make_mesh
    from hpa2_tpu_torch.parallel.sharding import run_node_sharded

    cfg = SystemConfig(num_procs=32, msg_buffer_size=16,
                       semantics=Semantics().robust())
    arrays = gen_uniform_random_arrays(cfg, 64, 12, seed=9)
    kw = dict(block=32, cycles_per_call=16, snapshots=not packed,
              packed=packed)
    ref = CudaEngine(cfg, *arrays, device="cuda", **kw).run()
    meshes = [(2, 1)] + ([(4, 1), (2, 2)] if two_cards >= 4 else [])
    for node, data in meshes:
        eng = NodeShardedCudaEngine(cfg, *arrays, mesh=make_mesh(
            node_shards=node, data_shards=data, device="cuda"), **kw)
        run_node_sharded([eng])
        for f, v in ref.state.items():
            assert _same(eng.state[f].cuda(), v), (node, data, f)
        assert eng.cross_shard_msgs > 0
        want = dict(plan_collectives(make_plan(node, "a2a")), sum=1, max=1,
                    min=0)
        assert eng.step_collectives == want


def test_node_sharded_contract_on_four_cards(card):
    """``node-sharded-pallas-a2a`` over four NCCL ranks: clean."""
    from hpa2_tpu_torch.analysis import contracts

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs (one NCCL rank a card)")
    results = contracts.run_contracts(names=["node-sharded-pallas-a2a"],
                                      device="cuda", out=lambda line: None)
    assert [r.status for r in results] == ["ok"], results


@pytest.mark.parametrize("n,d,mode,packed", [
    (8, 2, "a2a", False), (22, 2, "pairwise", False), (12, 2, "a2a", True),
    (64, 4, "butterfly", False), (8, 4, "hier", False)])
def test_node_kernels_over_logical_ranks_match_k2_on_card(card, n, d, mode,
                                                         packed):
    """K1's node-sharded cycle as its four kernels (N1-N4) over logical
    ranks on one card: every launch held against its plain version on
    the same inputs, and the gathered planes equal to K2's run."""
    from hpa2_tpu_torch.ops import node_cycle
    from hpa2_tpu_torch.parallel import NodeShardedCudaEngine, make_mesh

    cfg = SystemConfig(num_procs=n, msg_buffer_size=16,
                       semantics=Semantics().robust(), exchange_mode=mode)
    arrays = gen_uniform_random_arrays(cfg, 128, 12, seed=n)
    kw = dict(block=64, cycles_per_call=16, snapshots=not packed,
              packed=packed)
    ref = CudaEngine(cfg, *arrays, device="cuda", **kw).run()
    for e in node_cycle.NODE_KERNELS:
        e.launches = 0
    eng = NodeShardedCudaEngine(cfg, *arrays, mesh=make_mesh(
        node_shards=d, device="cuda", local=True), _check_calls=1_000,
        **kw).run()
    for f, v in ref.state.items():
        assert _same(eng.state[f].cuda(), v), f
    assert all(e.launches for e in node_cycle.NODE_KERNELS)
    for st in eng.rank_stats:
        for k, (c, x) in st["checked"].items():
            assert c == st["launches"][k] > 0 and x == 0, k


def test_node_kernels_refuse_wider_systems_on_card(card):
    """Above the node kernels' 16 shards the node-sharded path raises on
    the card unless ``cycle="tensor"`` is named; a system wider than the
    register instantiations' 64 nodes (128) runs on the wide family with
    no cycle named, and equals its ``cycle="tensor"`` run."""
    from hpa2_tpu_torch.ops import node_cycle
    from hpa2_tpu_torch.parallel import NodeShardedCudaEngine, make_mesh

    cfg = SystemConfig(num_procs=128, msg_buffer_size=16,
                       semantics=Semantics().robust())
    arrays = gen_uniform_random_arrays(cfg, 2, 2, seed=1)
    with pytest.raises(RuntimeError, match="cycle='tensor'"):
        NodeShardedCudaEngine(cfg, *arrays, mesh=make_mesh(
            node_shards=32, device="cuda", local=True), block=2).run()
    mesh = make_mesh(node_shards=2, device="cuda", local=True)
    eng = NodeShardedCudaEngine(cfg, *arrays, mesh=mesh, block=2).run()
    ref = NodeShardedCudaEngine(cfg, *arrays, mesh=mesh, block=2,
                                cycle="tensor").run()
    assert eng.instructions == int(np.asarray(arrays[3]).sum())
    assert set(ref.rank_stats[0]["launches"].values()) == {0}
    assert all(eng.rank_stats[0]["launches"][e.name]
               for e in node_cycle.WIDE_KERNELS)
    for f, v in ref.state.items():
        assert torch.equal(eng.state[f], v), f


@pytest.mark.parametrize("n,d,mode", [
    (96, 2, "a2a"), (160, 4, "pairwise"), (256, 4, "hier"),
    (4096, 4, "a2a")])
def test_wide_node_kernels_held_against_plain_on_card(card, n, d, mode):
    """The wide family (``node_*_wide``) over logical ranks on one card:
    every launch of the first call held against its plain version on
    the same inputs (max_abs_err 0), every instruction retired; below
    4,096 nodes the gathered planes equal the ``cycle="tensor"`` run's."""
    from hpa2_tpu_torch.ops import node_cycle
    from hpa2_tpu_torch.parallel import NodeShardedCudaEngine, make_mesh

    cfg = SystemConfig(num_procs=n, msg_buffer_size=8,
                       semantics=Semantics().robust(), exchange_mode=mode)
    b, t = (8, 2) if n == 4096 else (32, 6)
    arrays = gen_uniform_random_arrays(cfg, b, t, seed=n)
    mesh = make_mesh(node_shards=d, device="cuda", local=True)
    kw = dict(block=b, cycles_per_call=4, snapshots=n < 4096)
    for e in node_cycle.WIDE_KERNELS:
        e.launches = 0
    eng = NodeShardedCudaEngine(cfg, *arrays, mesh=mesh, _check_calls=1,
                                **kw).run()
    assert eng.instructions == int(np.asarray(arrays[3]).sum())
    assert all(e.launches for e in node_cycle.WIDE_KERNELS)
    for st in eng.rank_stats:
        for k, (c, x) in st["checked"].items():
            assert c >= 4 and x == 0, k
    if n < 4096:
        ref = NodeShardedCudaEngine(cfg, *arrays, mesh=mesh, cycle="tensor",
                                    **kw).run()
        for f, v in ref.state.items():
            assert torch.equal(eng.state[f], v), f


def test_node_kernels_over_nccl_held_against_plain(two_cards):
    """Over NCCL ranks (two, one a card) the first k-cycle call's N1-N4
    launches each equal their plain version on the same inputs."""
    from hpa2_tpu_torch.parallel import NodeShardedCudaEngine, make_mesh

    cfg = SystemConfig(num_procs=32, msg_buffer_size=16,
                       semantics=Semantics().robust())
    arrays = gen_uniform_random_arrays(cfg, 64, 12, seed=4)
    kw = dict(block=32, cycles_per_call=16)
    ref = CudaEngine(cfg, *arrays, device="cuda", **kw).run()
    eng = NodeShardedCudaEngine(cfg, *arrays, mesh=make_mesh(
        node_shards=2, data_shards=1, device="cuda"), _check_calls=1,
        **kw).run()
    for f, v in ref.state.items():
        assert _same(eng.state[f].cuda(), v), f
    for st in eng.rank_stats:
        assert all(st["launches"].values())
        for k, (c, x) in st["checked"].items():
            assert c >= 16 and x == 0, k
