"""The largest lane block the fast-path kernels take on the card, at each
node bound; ``kernels.MAX_LANE_BLOCK`` holds what it found.

    python -m hpa2_tpu_torch.scripts.block_limits

For each node bound (8, 21 and 64 nodes: 2, 8 and 16 threads a system)
and each plane kind (int32, packed), asks the card
(``CudaKernel.occupancy``) about lane blocks of one cluster of
``MAX_CLUSTER`` full CTAs in 1, 2, ... rounds a CTA, until it refuses
one (a CTA's dynamic shared memory grows with its rounds).  Then, on
int32 planes, launches the streamed kernel at the largest block it
accepted on a small random workload and holds every plane against the
plain version, and launches it at one round more (past the Python-side
check, straight into the library) to see the launch refused.  Prints a
line per bound and kind, the card's name and power limit, and one JSON
line.  Needs an NVIDIA GPU with nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from hpa2_tpu_torch.config import Semantics, SystemConfig
from hpa2_tpu_torch.convert import state_from_numpy
from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.ops.layout import _init_state, _pack_traces, fields_of
from hpa2_tpu_torch.ops.stream_run import stream_run_plain
from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

#: one system geometry a node bound: (num_procs, cache_size, mem_size)
BOUNDS = {8: (8, 4, 16), 21: (12, 4, 8), 64: (64, 2, 4)}


def _config(bound: int) -> SystemConfig:
    n, c, m = BOUNDS[bound]
    return SystemConfig(num_procs=n, cache_size=c, mem_size=m,
                        msg_buffer_size=16, semantics=Semantics().robust())


def _block_of(cfg: SystemConfig, rounds: int) -> int:
    return kernels.MAX_CLUSTER * (
        kernels.MAX_CTA // kernels.threads_per_system(cfg)) * rounds


def probe(bound: int, packed: bool, dev: torch.device) -> dict:
    """The largest block of whole rounds the card accepts, with what it
    said of that block, and the first round count it refused."""
    cfg = _config(bound)
    best = None
    for rounds in range(1, 64):
        block = _block_of(cfg, rounds)
        args = kernels.geometry_args(cfg, lanes=block, block=block,
                                     packed=packed)
        try:
            occ = kernels.STREAM_RUN.occupancy(args, device=dev)
        except RuntimeError as e:
            return dict(best, refused_rounds=rounds, refused=str(e))
        if occ["clusters"] < 1:
            return dict(best, refused_rounds=rounds,
                        refused="no cluster fits at once")
        best = dict(block=block, rounds=rounds, **occ)
    raise AssertionError(f"bound {bound}: no refusal up to 63 rounds")


def _planes(cfg, lanes, dev, t=4, seed=0):
    arrays = gen_uniform_random_arrays(cfg, lanes, t, seed=seed)
    tr = torch.from_numpy(_pack_traces(cfg, *arrays)).to(dev)
    tr_len = torch.from_numpy(np.ascontiguousarray(arrays[3].T)).to(dev)
    state = state_from_numpy(_init_state(cfg, lanes, snapshots=False), dev)
    return state, tr, tr_len


def _launch(cfg, state, tr, tr_len, kw):
    """K2 straight from the library (past ``kernels.check_block``, so
    that the card and not the table decides); returns the stall
    plane."""
    status = torch.empty((1, tr_len.shape[1]), dtype=torch.int32,
                         device=tr.device)
    args = kernels._kernel_args(cfg, state, tr, tr_len, status, **kw)
    kernels.STREAM_RUN.launch(ctypes.byref(args), device=tr.device)
    torch.cuda.synchronize()
    return status


def launch_check(bound: int, block: int, dev: torch.device) -> dict:
    """K2 at ``block`` lanes (one block) against the plain version, and
    the card's refusal of one round more."""
    cfg = _config(bound)
    kw = dict(block=block, k=32, window=4, n_seg=1, max_calls=100,
              gate=True, snapshots=False)
    state, tr, tr_len = _planes(cfg, block, dev)
    got = {f: v.clone() for f, v in state.items()}
    status = _launch(cfg, got, tr, tr_len, kw)
    want, want_status = stream_run_plain(cfg, state, tr, tr_len, **kw)
    diff = {f: int((got[f].long() - want[f].long()).abs().max())
            for f in fields_of(cfg, False)}
    diff["status"] = int((status.long() - want_status.long()).abs().max())
    retired = int(got["scalars"][1].sum())
    if any(diff.values()) or retired != block * cfg.num_procs * 4:
        raise AssertionError(
            f"bound {bound} block {block}: planes differ {diff}, "
            f"{retired} instructions retired")
    more = block + _block_of(cfg, 1)
    state, tr, tr_len = _planes(cfg, more, dev, seed=1)
    try:
        _launch(cfg, state, tr, tr_len, dict(kw, block=more))
        refused = None
    except RuntimeError as e:
        refused = str(e)
    if refused is None:
        raise AssertionError(
            f"bound {bound}: the card ran a lane block of {more}")
    return dict(max_abs_err=max(diff.values()), retired=retired,
                refused_block=more, refused=refused)


def main() -> int:
    if not torch.cuda.is_available():
        print("block_limits: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kernels.build_all()
    out = {}
    for bound in BOUNDS:
        for packed in (False, True):
            p = probe(bound, packed, dev)
            print(f"[limits] node bound {bound} packed {packed}: block "
                  f"{p['block']} ({p['rounds']} rounds of {p['threads']} "
                  f"threads, {p['smem']} B dynamic shared memory a CTA, "
                  f"{p['ctas_per_sm']} CTAs an SM, {p['clusters']} "
                  f"clusters of {p['cl']} at once); {p['refused_rounds']} "
                  f"rounds refused: {p['refused']}")
            out[f"{bound}{' packed' if packed else ''}"] = p
        launch = launch_check(bound, out[str(bound)]["block"], dev)
        print(f"[limits] node bound {bound}: K2 at block "
              f"{out[str(bound)]['block']} equals the plain version "
              f"(max_abs_err={launch['max_abs_err']}, {launch['retired']} "
              f"instructions); block {launch['refused_block']} refused: "
              f"{launch['refused']}")
        out[str(bound)]["launch"] = launch
    table = {b: out[str(b)]["block"] for b in BOUNDS}
    for b in BOUNDS:
        if out[f"{b} packed"]["block"] != table[b]:
            raise AssertionError(f"bound {b}: packed and int32 differ")
    print(card)
    print(json.dumps({"card": card, "max_lane_block": table,
                      "table_in_kernels": kernels.MAX_LANE_BLOCK,
                      "probes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
