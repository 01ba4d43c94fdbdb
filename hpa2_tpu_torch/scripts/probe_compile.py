"""Build-and-geometry probe of the fast path's kernels on one NVIDIA GPU
(no run): the Hopper budget model against what the card makes of a lane
block.

    python -m hpa2_tpu_torch.scripts.probe_compile [--block 1024]
        [--window 16] [--gate] [--packed] [--nodes 8]

The port of ``scripts/probe_compile.py``.  For each of K2 (the streamed
run, ``csrc/stream_run.cu``) and K3 (the per-call kernel,
``csrc/call_run.cu``) at the lane block, node count and plane layout
given, it prints one JSON line with:

* the budget model (``analysis/vmem.py:vmem_budget``): a CTA's dynamic
  shared memory, threads, CTAs a cluster, CTAs an SM by threads and
  shared memory, and whether it fits under the 232,448 B a CTA may opt
  into;
* the card's figures for the same launch (``CudaKernel.occupancy``,
  which launches nothing): shared memory and threads a CTA, CTAs an SM
  and clusters the card holds at once;
* ptxas's census of the instantiation that launch takes
  (``analysis/ir.py:ptxas_census``): registers, stack frame and spills.

It exits 0 when every build succeeds, the card takes both launch
configurations and its shared memory, threads and cluster equal the
model's; otherwise nonzero, with the error's tail in the line
(``error_tail``).  ``--window`` and ``--gate`` size the model's device
planes and are recorded; a CTA's shared memory does not depend on them.

The JAX script's ``--legacy`` (the old per-call kernel that kept the
planes resident in VMEM) has no counterpart: every kernel of the port
keeps its planes in device memory and only per-system records in shared
memory.  It needs the card: without one it raises."""

from __future__ import annotations

import argparse
import json
import sys
import time


def model_figures(config, block: int, window: int, *, gate: bool = False,
                  stream: bool = True, packed: bool = False) -> dict:
    """The budget model's figures for one lane block of ``block``."""
    from hpa2_tpu_torch.analysis.vmem import vmem_budget

    bud = vmem_budget(config, block, window, gate=gate, stream=stream,
                      packed=packed)
    return {"model_smem_bytes": bud.smem_bytes,
            "model_threads": bud.cta_threads, "model_cl": bud.cl,
            "model_group": bud.group, "model_rounds": bud.rounds,
            "model_headroom_bytes": bud.headroom_bytes,
            "model_ctas_per_sm": bud.ctas_per_sm, "model_fits": bud.fits,
            "model_plane_bytes": bud.plane_bytes}


def instantiation(kern, config, packed: bool) -> str:
    """The mangled name's template arguments of the instantiation a
    launch at ``config`` takes (``<node bound, PACKED>``)."""
    from hpa2_tpu_torch.ops import kernels

    return (f"{kern.name}_kernelILi{kernels.node_bound(config)}ELb"
            f"{int(packed)}E")


def probe(kern, config, block: int, window: int, *, gate: bool,
          packed: bool, device) -> dict:
    """One kernel's record (see the module docstring)."""
    from hpa2_tpu_torch.analysis.ir import ptxas_census
    from hpa2_tpu_torch.ops import kernels

    rec = {"kernel": kern.name, "nodes": config.num_procs,
           "bound": kernels.node_bound(config), "block": block,
           "window": window, "gate": gate, "packed": packed,
           **model_figures(config, block, window, gate=gate,
                           stream=kern is kernels.STREAM_RUN,
                           packed=packed)}
    t0 = time.perf_counter()
    try:
        kernels.check_block(config, block)
        kern.build()
        rec["build_s"] = round(time.perf_counter() - t0, 1)
        occ = kern.occupancy(kernels.geometry_args(
            config, lanes=block, block=block, packed=packed), device=device)
    except (RuntimeError, ValueError) as e:
        rec.update(ok=False, error_tail=str(e)[-800:])
        return rec
    rec.update(smem_bytes=occ["smem"], threads=occ["threads"],
               cl=occ["cl"], ctas_per_sm=occ["ctas_per_sm"],
               clusters=occ["clusters"])
    name = instantiation(kern, config, packed)
    rec["ptxas"] = [
        {k: v for k, v in e.items() if k != "name"}
        for e in ptxas_census(kern.build_log) if name in e["name"]]
    agree = (occ["smem"], occ["threads"], occ["cl"]) == (
        rec["model_smem_bytes"], rec["model_threads"], rec["model_cl"])
    rec["model_vs_measured"] = round(
        rec["model_smem_bytes"] / max(occ["smem"], 1), 3)
    rec["ok"] = bool(agree and rec["model_fits"] and occ["clusters"] > 0)
    if not rec["ok"]:
        rec["error_tail"] = (
            f"model {rec['model_smem_bytes']} B, {rec['model_threads']} "
            f"threads, {rec['model_cl']} CTAs; card {occ}")
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="probe_compile")
    p.add_argument("--block", type=int, default=1024)
    p.add_argument("--window", type=int, default=16)
    p.add_argument("--gate", action="store_true")
    p.add_argument("--packed", action="store_true")
    p.add_argument("--nodes", type=int, default=8)
    args = p.parse_args(argv)

    import torch

    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.ops import kernels
    from hpa2_tpu_torch.ops.cuda_engine import resolve_device
    from hpa2_tpu_torch.scripts.perf_sweep import _where

    dev = torch.device(resolve_device("cuda"))
    config = SystemConfig(num_procs=args.nodes, msg_buffer_size=16,
                          semantics=Semantics().robust())
    kernels.check_kernel_bound(config)
    for kern in kernels.KERNELS:
        kern.start_build()
    ok = True
    for kern in kernels.KERNELS:
        rec = probe(kern, config, args.block, args.window, gate=args.gate,
                    packed=args.packed, device=dev)
        rec.update(_where(dev))
        print(json.dumps(rec), flush=True)
        ok = ok and rec["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
