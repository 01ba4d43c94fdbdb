"""Micro-benchmarks of the op patterns inside the cycle kernel, on the
GPU: the counterpart of ``scripts/micro_kernels.py``.

    python -m hpa2_tpu_torch.scripts.micro_kernels [--device cuda|cpu]

Each pattern runs ``K`` iterations over lane-last int32 planes, one
thread per lane and one block of ``B`` lanes per CTA
(``csrc/micro_kernels.cu``), and is timed per iteration.  Patterns:

  empty        identity with the full-size carry
  scalar_gate  the block's integer sum of two planes and a cond on it
  deliver40    40 candidate mailbox writes (phase C)
  rw_9x        6 reads and 3 writes of a [N, M] plane per node (phase A)
  rowops300    100 dependent integer steps per node (handler math)

:func:`main` makes the JAX script's inputs from the same seed and
prints one JSON line per pattern with its keys (``name``,
``us_per_iter_per_block``, ``block_b``, ``grid``, ``checksum``,
``total_s``), plus ``device`` and, for ``deliver40``, ``accepted``.
``--device cpu`` runs the plain PyTorch versions instead of the kernels.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.ops.cuda_engine import resolve_device

I32 = torch.int32
N, CAP, M, B = 8, 16, 16, 256
K = 256
J = 40

#: each pattern's planes, in the JAX script's order (the first is the
#: one its checksum sums), and its index in csrc/micro_kernels.cuh
PATTERNS = {
    "empty": ("mb", "mem", "rows"),
    "scalar_gate": ("rows", "cnt"),
    "deliver40": ("mb", "rows", "cnt"),
    "rw_9x": ("mem", "rows"),
    "rowops300": ("rows", "cnt"),
}
SHAPES = {"mb": (N, CAP), "mem": (N, M), "rows": (N,), "cnt": (N,)}

#: clocks the stream sleeps before a timed launch (~0.5 ms): longer
#: than the host's share of a launch
SLEEP_CYCLES = 1_000_000

#: kernel launches per pattern (the plain versions do not count)
LAUNCHES = {name: 0 for name in PATTERNS}


def make_arrays(total: int) -> Dict[str, np.ndarray]:
    """The JAX script's inputs at ``total`` lanes: ``mb``, ``mem`` and
    ``rows`` from ``np.random.default_rng(0)`` in that order, ``cnt``
    zeros."""
    rng = np.random.default_rng(0)
    mb = rng.integers(0, 1 << 27, (N, CAP, total), dtype=np.int32)
    mem = rng.integers(0, 256, (N, M, total), dtype=np.int32)
    rows = rng.integers(0, 128, (N, total), dtype=np.int32)
    cnt = np.zeros((N, total), np.int32)
    return {"mb": mb, "mem": mem, "rows": rows, "cnt": cnt}


def checksum(x: torch.Tensor) -> int:
    """The JAX script's ``int(jnp.sum(out[0]))``: the sum wrapped to
    int32, as an int32 sum wraps."""
    s = int(x.sum(dtype=torch.int64))
    return (s + (1 << 31)) % (1 << 32) - (1 << 31)


# --- the plain versions (the JAX bodies, scripts/micro_kernels.py:87-148)


def _empty(s, iters, block):
    return dict(s)


def _scalar_gate(s, iters, block):
    rows, cnt = s["rows"], s["cnt"]
    for _ in range(iters):
        # the block's active count; both branches of the cond return
        # the planes unchanged
        torch.stack([rows, cnt]).reshape(2 * N, -1, block).sum((0, 2))
    return {"rows": rows, "cnt": cnt}


def _deliver40(s, iters, block):
    mb, rows, cnt = s["mb"], s["rows"], s["cnt"]
    iota_cap = torch.arange(CAP, dtype=I32, device=mb.device)[None, :, None]
    iota_n = torch.arange(N, dtype=I32, device=mb.device)[:, None]
    for _ in range(iters):
        acc = torch.zeros_like(cnt)
        for j in range(J):
            recv = (rows[j % N] + j) & 7
            valid = ((rows[(j + 1) % N] >> (j & 3)) & 1) == 1
            valid_nb = valid[None, :] & (iota_n == recv[None, :])
            pos = cnt + acc
            accepted = valid_nb & (pos < CAP)
            hot = (iota_cap == pos[:, None, :]) & accepted[:, None, :]
            w = rows[j % N] * 3 + j
            mb = torch.where(hot, w[None, None, :], mb)
            acc = acc + accepted.to(I32)
        cnt = cnt + acc
    return {"mb": mb, "rows": rows, "cnt": cnt}


def _rw_9x(s, iters, block):
    mem, rows = s["mem"], s["rows"]
    iota_m = torch.arange(M, dtype=I32, device=mem.device)[None, :, None]
    for _ in range(iters):
        out = rows
        for r in range(6):
            idx = (rows + r) & (M - 1)
            out = out + mem.gather(1, idx[:, None, :].long())[:, 0]
        for w in range(3):
            idx = (out + w) & (M - 1)
            mask = (out & 1) == 0
            hot = (iota_m == idx[:, None, :]) & mask[:, None, :]
            mem = torch.where(hot, out[:, None, :], mem)
        rows = out & 127
    return {"mem": mem, "rows": rows}


def _rowops300(s, iters, block):
    x, y = s["rows"], s["cnt"]
    for _ in range(iters):
        for p in range(100):
            y = torch.where((x & 3) == (p & 3), y + x, y)
            x = (x * 5 + 1) & 1023
    return {"rows": x, "cnt": y}


PLAIN = {"empty": _empty, "scalar_gate": _scalar_gate,
         "deliver40": _deliver40, "rw_9x": _rw_9x, "rowops300": _rowops300}


def plain(name: str, arrays: Dict[str, torch.Tensor], *, iters: int,
          block: int) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of pattern ``name``: new planes, the
    inputs untouched."""
    return PLAIN[name]({k: arrays[k] for k in PATTERNS[name]}, iters, block)


def _check(name, arrays, block) -> int:
    if name not in PATTERNS:
        raise ValueError(f"no pattern {name!r}; one of {list(PATTERNS)}")
    planes = [arrays[k] for k in PATTERNS[name]]
    lanes = planes[0].shape[-1]
    if block < 32 or block > kernels.MAX_BLOCK or block % 32 \
            or lanes % block:
        raise ValueError(
            f"{lanes} lanes are not whole blocks of {block} (a block is "
            f"one CTA of whole warps, at most {kernels.MAX_BLOCK} threads)")
    dev = planes[0].device
    for k, x in zip(PATTERNS[name], planes):
        if x.device != dev:
            raise ValueError(f"plane {k!r} is on {x.device}, not {dev}")
        if x.dtype != I32:
            raise ValueError(f"plane {k!r} is {x.dtype}, expected int32")
        if tuple(x.shape) != SHAPES[k] + (lanes,):
            raise ValueError(f"plane {k!r} has shape {tuple(x.shape)}, "
                             f"expected {SHAPES[k] + (lanes,)}")
        if not x.is_contiguous():
            raise ValueError(f"plane {k!r} is not contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return lanes


def micro_run(name: str, arrays: Dict[str, torch.Tensor], *, iters: int,
              block: int) -> None:
    """``iters`` iterations of pattern ``name`` on ``arrays`` (its
    planes, [..., lanes] int32), updated in place, ``block`` lanes per
    CTA.  CPU tensors run the plain version; CUDA tensors launch the
    kernel (asynchronously, on the current stream) or raise."""
    lanes = _check(name, arrays, block)
    if iters < 0:
        raise ValueError(f"iters={iters} is negative")
    dev = arrays[PATTERNS[name][0]].device
    if dev.type == "cpu":
        for k, v in plain(name, arrays, iters=iters, block=block).items():
            arrays[k].copy_(v)
        return
    ptr = {k: arrays[k].data_ptr() if k in PATTERNS[name] else None
           for k in SHAPES}
    kernels.MICRO.launch(list(PATTERNS).index(name), ptr["mb"], ptr["mem"],
                         ptr["rows"], ptr["cnt"], lanes, iters, block,
                         device=dev)
    LAUNCHES[name] += 1


def bench(name: str, arrays: Dict[str, np.ndarray], grid: int = 32, *,
          device) -> dict:
    """Time ``K`` iterations of pattern ``name`` over ``grid`` blocks of
    ``B`` lanes (``arrays``: numpy planes [..., B * grid]); prints and
    returns the JSON record.  Each launch gets fresh copies of the
    inputs (made outside the timed region); after a warm-up, the median
    of 3 launches timed by CUDA events around the kernel alone (by the
    host clock around the plain version on the CPU)."""
    dev = resolve_device(device)
    src = {k: torch.from_numpy(np.ascontiguousarray(arrays[k])).to(dev)
           for k in PATTERNS[name]}
    lanes = src[PATTERNS[name][0]].shape[-1]
    if lanes != B * grid:
        raise ValueError(f"{lanes} lanes are not {grid} blocks of {B}")
    micro_run(name, {k: v.clone() for k, v in src.items()}, iters=K,
              block=B)
    times = []
    for _ in range(3):
        out = {k: v.clone() for k, v in src.items()}
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            # the stream sleeps while the host enqueues the start event
            # and the launch, so the events time the kernel and not the
            # wrapper's host work
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            micro_run(name, out, iters=K, block=B)
            end.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            micro_run(name, out, iters=K, block=B)
            times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    rec = {"name": name, "us_per_iter_per_block": dt / K / grid * 1e6,
           "block_b": B, "grid": grid,
           "checksum": checksum(out[PATTERNS[name][0]]), "total_s": dt,
           "device": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu"}
    if name == "deliver40":
        rec["accepted"] = int(out["cnt"].sum(dtype=torch.int64)
                              - src["cnt"].sum(dtype=torch.int64))
    print(json.dumps(rec), flush=True)
    return rec


def main(device="cuda") -> List[dict]:
    """Every pattern at ``grid=32`` (8,192 lanes) on ``device``; the
    GPU unless ``device="cpu"``, which runs the plain versions."""
    resolve_device(device)
    arrays = make_arrays(B * 32)
    return [bench(name, arrays, device=device) for name in PATTERNS]


def _cli(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m hpa2_tpu_torch.scripts.micro_kernels",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the plain PyTorch versions")
    main(ap.parse_args(argv).device)


if __name__ == "__main__":
    _cli()
