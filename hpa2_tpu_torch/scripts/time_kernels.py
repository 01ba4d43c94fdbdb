"""Time the fast path's kernels on one NVIDIA GPU at the repo's two
full-width configurations.

    python hpa2_tpu_torch/scripts/time_kernels.py [--tree DIR] [--reps N]

Times K2 (``kernels.stream_run``, the whole streamed run) and K3
(``kernels.call_run`` under its host loop ``run_windows``, each launch
timed) at the 8-node headline (32,768 systems x 8 nodes x 128
instructions, block 512, window 32, k 128) and at 64 nodes (1,024 x 64
x 64, block 512, window 16, k 64; K2 also with packed planes), each
launch on fresh planes made from seed 0, timed by CUDA events around
the launch alone.

``--tree DIR`` times the ``hpa2_tpu_torch`` package of another checkout
(its kernels are built from its own sources), so that two versions can
be timed in turns (A, B, B, A) in one session on one card; the script
uses only what both versions have.  Prints one JSON line: the card,
the tree, and per path the ms of each repetition, the RD/WR
instructions retired, the system-cycles (the sum of the cycle counter
over systems), the longest system's cycles, and a digest of the final
planes (equal digests, equal planes).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

#: the paths: (name, kernel, num_procs, batch, instrs, block, window, k,
#: packed); headline: bench.py:50-51, 74-82; 64 nodes:
#: scripts/scale_runs.py:265-276
PATHS = (
    ("K2 headline", "stream", 8, 32768, 128, 512, 32, 128, False),
    ("K3 headline", "call", 8, 32768, 128, 512, 32, 128, False),
    ("K2 64 nodes", "stream", 64, 1024, 64, 512, 16, 64, False),
    ("K3 64 nodes", "call", 64, 1024, 64, 512, 16, 64, False),
    ("K2 64 nodes packed", "stream", 64, 1024, 64, 512, 16, 64, True),
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                   help="checkout whose hpa2_tpu_torch is timed")
    p.add_argument("--reps", type=int, default=2)
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import numpy as np
    import torch

    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.convert import state_from_numpy
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.call_run import run_windows
    from hpa2_tpu_torch.ops.layout import _init_state, _pack_traces
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    if not torch.cuda.is_available():
        print("time_kernels: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kernels.build_all()

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        return start, end

    out = {}
    for name, kern, n, b, t, block, window, k, packed in PATHS:
        cfg = SystemConfig(num_procs=n, msg_buffer_size=16,
                           semantics=Semantics().robust())
        op, addr, val, length = gen_uniform_random_arrays(cfg, b, t, seed=0)
        n_seg = -(-t // window)
        tr = np.pad(_pack_traces(cfg, op, addr, val, length),
                    ((0, 0), (0, n_seg * window - t), (0, 0)))
        tr = torch.from_numpy(tr).cuda()
        tr_len = torch.from_numpy(np.ascontiguousarray(length.T)).cuda()
        state = state_from_numpy(_init_state(cfg, b, False, packed), "cuda")
        kw = dict(block=block, k=k, window=window, n_seg=n_seg,
                  max_calls=10_000, gate=True, snapshots=False,
                  packed=packed)
        times = []
        for rep in range(args.reps + 1):  # the first is a warm-up
            got = {f: v.clone() for f, v in state.items()}
            torch.cuda.synchronize()
            events = []
            if kern == "stream":
                events.append(timed(
                    lambda: kernels.stream_run(cfg, got, tr, tr_len, **kw)))
            else:
                def call(*a, **kk):
                    events.append(timed(lambda: kernels.call_run(*a, **kk)))
                run_windows(cfg, got, tr, tr_len, call=call, **kw)
            torch.cuda.synchronize()
            if rep:
                times.append(sum(s.elapsed_time(e) for s, e in events))
        digest = hashlib.sha256()
        for f in sorted(got):
            digest.update(f.encode())
            digest.update(got[f].cpu().numpy().tobytes())
        cyc = got["scalars"][0].long()
        out[name] = dict(ms=times, launches=len(events),
                         instructions=int(got["scalars"][1].long().sum()),
                         system_cycles=int(cyc.sum()),
                         max_cycle=int(cyc.max()),
                         digest=digest.hexdigest()[:16])
        print(f"[time_kernels] {name}: {times} ms", file=sys.stderr)
    print(json.dumps({"card": card, "tree": args.tree, "paths": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
