"""The CUDA kernels on the card against their plain PyTorch versions
(every node bound: 8, 21 and 64 with split sharer planes, and packed
planes): the streamed run, and the per-call kernel under its host
loop; and the engine's ``run`` on the card against the CPU, unscheduled
and scheduled.  These need an NVIDIA GPU with nvcc (sm_90a) and skip
elsewhere; on the card run them with

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
