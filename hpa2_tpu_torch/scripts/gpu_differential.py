"""On-card differential: K2, the streamed fast-path kernel
(``CudaEngine``), against the port's general engine
(``ops/engine.py:build_batched_run``), both on one NVIDIA GPU, on the
same random workloads.

    python -m hpa2_tpu_torch.scripts.gpu_differential

The port of ``scripts/tpu_differential.py``: its two geometries, the
8-node one (128 systems x 24 instructions, mailbox 32, seed 7) and the
33-node one on split sharer planes (16 systems x 10, seed 11), plus the
eviction ping-pong workload (``utils/trace.py:gen_eviction_pingpong``,
the reference's hang class) at the two adversarial geometries of
``tests/test_random_differential.py`` that the JAX sweep runs on its
fast path (4 nodes, mailbox 8, 20 x 24, seed 7000; 8 nodes, mailbox 6,
16 x 20, seed 7002).  Per system: every final dump field (memory,
directory state and sharers, cache lines) and the instruction and
message counts must agree, and so must which systems stall (a tiny
mailbox can deadlock; the general engine then stops on its watchdog).
Every K2 launch is also held against its plain version on a copy of its
planes, bit for bit.

Prints one JSON line and exits 0 on agreement, 1 otherwise.  It refuses
to run without CUDA (there is no interpreted escape hatch: the point is
the card's kernel)."""

from __future__ import annotations

import json
import sys

#: K2 and the general engine run at most this many cycles (a live
#: system of these workloads quiesces within a few hundred, and each K2
#: launch's plain check runs as many cycles as the launch); a deadlocked
#: system stops the general engine after WATCHDOG cycles without progress
MAX_CYCLES = 8_192
WATCHDOG = 256


def _checked_stream_run(rec):
    """``kernels.stream_run`` with every launch held against the plain
    version on a copy of its planes (on the card); ``rec`` counts the
    checks and keeps the largest difference."""
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.stream_run import stream_run_plain

    launch = kernels.stream_run

    def stream_run(config, state, tr, tr_len, **kw):
        before = {f: v.clone() for f, v in state.items()}
        status = launch(config, state, tr, tr_len, **kw)
        want, want_status = stream_run_plain(config, before, tr, tr_len,
                                             **kw)
        err = int((status.long() - want_status.long()).abs().max())
        for f, v in want.items():
            err = max(err, int((state[f].long() - v.long()).abs().max()))
        rec["checked"] += 1
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        return status

    return launch, stream_run


def compare(tag, config, arrays, *, device="cuda") -> dict:
    """K2 and the general engine on ``arrays``; the record of one
    geometry."""
    import numpy as np
    import torch

    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
    from hpa2_tpu_torch.ops.engine import (
        _dumps, _live_arrays, build_batched_run,
    )
    from hpa2_tpu_torch.ops.layout import (
        _SC_INSTR, _SC_MSGS, StallError, _scalar_layout,
    )
    from hpa2_tpu_torch.ops.state import init_state_batched
    from hpa2_tpu_torch.ops.step import quiescent
    from hpa2_tpu_torch.ops.stream_run import active_count

    batch = arrays[0].shape[0]
    rec = {"checked": 0, "max_abs_err": 0}
    eng = CudaEngine(config, *arrays, device=device)
    before = kernels.STREAM_RUN.launches
    launch, checked = _checked_stream_run(rec)
    kernels.stream_run = checked
    try:
        eng.run(max_cycles=MAX_CYCLES)
        k2_stalled_any = False
    except StallError:
        k2_stalled_any = True
    finally:
        kernels.stream_run = launch
    launches = kernels.STREAM_RUN.launches - before
    slsc = _scalar_layout(config, eng._window)
    tl = eng._tr_len_full.clamp(0, eng._window)
    k2_stalled = (active_count(config, eng.state, tl, slsc) != 0).cpu()

    st = init_state_batched(config, *arrays, device=device)
    st = build_batched_run(config, max_cycles=MAX_CYCLES,
                           watchdog_cycles=WATCHDOG)(st)
    gen_stalled = (~quiescent(st)).cpu()

    sc = eng.state["scalars"].cpu().numpy()
    instr_gen = st.n_instr.cpu().numpy()
    msgs_gen = st.n_msgs.cpu().numpy()
    mism = 0
    for b in range(batch):
        if bool(k2_stalled[b]) or bool(gen_stalled[b]):
            continue
        k2 = [d.__dict__ for d in eng.system_final_dumps(b)]
        gen = [d.__dict__ for d in _dumps(config, _live_arrays(st, b))]
        mism += sum(x != y for x, y in zip(k2, gen))
    live = ~(k2_stalled | gen_stalled).numpy()
    counts_ok = bool(
        np.array_equal(sc[_SC_INSTR][live], instr_gen[live])
        and np.array_equal(sc[_SC_MSGS][live], msgs_gen[live]))
    stalls_agree = bool(torch.equal(k2_stalled, gen_stalled))
    ok = (mism == 0 and counts_ok and stalls_agree
          and k2_stalled_any == bool(k2_stalled.any())
          and rec["max_abs_err"] == 0 and rec["checked"] == launches >= 1)
    return {
        "tag": tag, "ok": ok, "node_mismatches": mism,
        "instr_k2": int(sc[_SC_INSTR].sum()),
        "instr_general": int(instr_gen.sum()),
        "counts_agree": counts_ok, "stalled_systems": int(
            k2_stalled.sum()), "stalls_agree": stalls_agree,
        "k2_launches": launches, "plain_checked": rec["checked"],
        "max_abs_err": rec["max_abs_err"], "batch": batch,
        "num_procs": config.num_procs,
    }


def cases():
    """(tag, config, arrays) of every comparison."""
    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.utils.trace import (
        gen_eviction_pingpong_arrays, gen_uniform_random_arrays,
    )

    robust = Semantics().robust()
    c8 = SystemConfig(num_procs=8, msg_buffer_size=32, semantics=robust)
    c33 = SystemConfig(num_procs=33, cache_size=4, mem_size=8,
                       msg_buffer_size=32, semantics=robust)
    p4 = SystemConfig(num_procs=4, cache_size=4, mem_size=16,
                      msg_buffer_size=8, semantics=robust)
    p8 = SystemConfig(num_procs=8, cache_size=4, mem_size=8,
                      msg_buffer_size=6, semantics=robust)
    return [
        ("8n", c8, gen_uniform_random_arrays(c8, 128, 24, seed=7)),
        ("33n-split", c33, gen_uniform_random_arrays(c33, 16, 10, seed=11)),
        ("pingpong-4n", p4, gen_eviction_pingpong_arrays(p4, 20, 24,
                                                         seed=7000)),
        ("pingpong-8n", p8, gen_eviction_pingpong_arrays(p8, 16, 20,
                                                         seed=7002)),
    ]


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("gpu_differential: CUDA is not available; this script holds "
              "the card's kernel against the general engine on the card",
              file=sys.stderr)
        return 2
    from hpa2_tpu_torch.bench import card_info

    card = card_info(torch.device("cuda"))
    results = [compare(tag, cfg, arrays) for tag, cfg, arrays in cases()]
    ok = all(r["ok"] for r in results)
    print(json.dumps({"ok": ok, "card": f"{card['name']}, "
                      f"{card['power_limit']}", "geometries": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
