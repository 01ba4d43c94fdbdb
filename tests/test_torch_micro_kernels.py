"""The port's op-pattern micro-kernels (``hpa2_tpu_torch.scripts.
micro_kernels``) against the JAX script ``scripts/micro_kernels.py``.

The JAX script is loaded by path and left as it is.  A first copy's
``bench`` is replaced to capture each pattern's body and inputs from
its ``main()``; a second copy runs its own ``bench`` on the first 512
lanes (``grid=2``) with its ``pl.pallas_call`` in interpret mode, and
the recorded call gives every output array.  The port's plain version
must equal them bit for bit at the script's ``K`` (the int32
wraparound of ``rw_9x`` and the mailbox saturation of ``deliver40``
included), and its wrapped checksum the one the JAX ``bench`` printed.
The kernel's ``__host__ __device__`` per-lane bodies
(``csrc/micro_kernels.cuh``), built with g++, must equal the plain
version too."""

import ctypes
import hashlib
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.scripts import micro_kernels as mk
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCRIPT = pathlib.Path(__file__).resolve().parent.parent / "scripts" / \
    "micro_kernels.py"
NAMES = list(mk.PATTERNS)
#: the lanes of the comparisons with the JAX script: its first 2 blocks
LANES = 2 * mk.B


def _load_script(tag):
    spec = importlib.util.spec_from_file_location(
        f"_jax_micro_kernels_{tag}", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_patterns():
    """(body, inputs) of each pattern, as the JAX script's main() hands
    them to its bench."""
    mod = _load_script("capture")
    captured = {}

    def capture(name, body, arrs, grid=32):
        captured[name] = (body, arrs)

    mod.bench = capture
    mod.main()
    assert list(captured) == NAMES
    return captured


def _torch_planes(arrays, name, lanes):
    return {k: torch.from_numpy(np.ascontiguousarray(arrays[k][..., :lanes]))
            for k in mk.PATTERNS[name]}


@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_jax_script(name, jax_patterns, capsys):
    body, arrs = jax_patterns[name]
    assert list(arrs) == list(mk.PATTERNS[name])
    first = {k: v[..., :LANES] for k, v in arrs.items()}
    run = _load_script(name)
    real_pl, calls = run.pl, []

    def pallas_call(*args, **kw):
        calls.append(real_pl.pallas_call(*args, interpret=True, **kw))
        return calls[-1]

    run.pl = types.SimpleNamespace(pallas_call=pallas_call,
                                   BlockSpec=real_pl.BlockSpec)
    run.bench(name, body, first, grid=2)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(calls) == 1
    want = calls[0](*[jnp.asarray(v) for v in first.values()])

    got = _torch_planes(arrs, name, LANES)
    mk.micro_run(name, got, iters=mk.K, block=mk.B)
    for k, w in zip(first, want):
        assert np.array_equal(got[k].numpy(), np.asarray(w)), k
    assert mk.checksum(got[next(iter(first))]) == printed["checksum"]
    if name == "rw_9x":  # the sums wrapped
        assert int(got["mem"].min()) < 0
    if name == "deliver40":  # the mailboxes that receive fill to CAP
        assert set(got["cnt"].unique().tolist()) == {0, mk.CAP}


def test_bench_prints_the_script_keys(capsys):
    """main()'s code at grid=1 on the CPU: one JSON line a pattern with
    the JAX script's keys, the device and deliver40's accepted count."""
    arrays = mk.make_arrays(mk.B)
    recs = [mk.bench(name, arrays, grid=1, device="cpu") for name in NAMES]
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == recs
    keys = {"name", "us_per_iter_per_block", "block_b", "grid", "checksum",
            "total_s", "device"}
    for name, rec in zip(NAMES, recs):
        assert set(rec) == keys | ({"accepted"} if name == "deliver40"
                                   else set())
        assert (rec["name"], rec["block_b"], rec["grid"], rec["device"]) == \
            (name, mk.B, 1, "cpu")
        assert rec["us_per_iter_per_block"] == pytest.approx(
            rec["total_s"] / mk.K * 1e6)
    want = mk.plain("deliver40", _torch_planes(arrays, "deliver40", mk.B),
                    iters=mk.K, block=mk.B)
    rec = recs[NAMES.index("deliver40")]
    assert rec["checksum"] == mk.checksum(want["mb"])
    assert rec["accepted"] == int(want["cnt"].sum()) > 0  # cnt starts at 0


@pytest.mark.parametrize("fault", ["lanes", "block", "dtype", "shape",
                                   "contiguity", "iters"])
def test_micro_run_refuses_what_the_kernel_cannot_take(fault):
    planes = _torch_planes(mk.make_arrays(mk.B), "deliver40", mk.B)
    kw = dict(iters=1, block=mk.B)
    if fault == "lanes":
        planes = _torch_planes(mk.make_arrays(300), "deliver40", 300)
    elif fault == "block":
        kw["block"] = 48
    elif fault == "dtype":
        planes["cnt"] = planes["cnt"].long()
    elif fault == "shape":
        planes["mb"] = planes["mb"][:, :8].contiguous()
    elif fault == "contiguity":
        planes["rows"] = planes["rows"].t().contiguous().t()
    else:
        kw["iters"] = -1
    with pytest.raises(ValueError):
        mk.micro_run("deliver40", planes, **kw)


def test_plain_run_counts_no_launch():
    planes = _torch_planes(mk.make_arrays(mk.B), "rowops300", mk.B)
    before = dict(mk.LAUNCHES), kernels.MICRO.launches
    mk.micro_run("rowops300", planes, iters=2, block=mk.B)
    assert (dict(mk.LAUNCHES), kernels.MICRO.launches) == before


# --- the kernel's per-lane bodies, built for the host ------------------

SHIM = r"""
#include "micro_kernels.cuh"
template <int P> void lanes_of(const micro::Planes& p, int iters) {
  for (int l = 0; l < p.lanes; ++l) micro::run_lane<P>(p, l, iters);
}
// scalar_gate's block reduction as a loop over the block's lanes
void gate_blocks(const micro::Planes& p, int iters, int block) {
  for (int l0 = 0; l0 < p.lanes; l0 += block)
    for (int k = 0; k < iters; ++k) {
      uint32_t active = 0;
      for (int l = l0; l < l0 + block; ++l) active += micro::gate_lane(p, l);
      if (active == 0) break;
    }
}
extern "C" int micro_host_run(int pattern, int32_t* mb, int32_t* mem,
                              int32_t* rows, int32_t* cnt, int lanes,
                              int iters, int block) {
  const micro::Planes p{mb, mem, rows, cnt, lanes};
  switch (pattern) {
    case micro::EMPTY: lanes_of<micro::EMPTY>(p, iters); break;
    case micro::SCALAR_GATE: gate_blocks(p, iters, block); break;
    case micro::DELIVER40: lanes_of<micro::DELIVER40>(p, iters); break;
    case micro::RW_9X: lanes_of<micro::RW_9X>(p, iters); break;
    case micro::ROWOPS300: lanes_of<micro::ROWOPS300>(p, iters); break;
    default: return 1;
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_lib():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    h = hashlib.sha256(SHIM.encode())
    h.update((kernels.CSRC_DIR / "micro_kernels.cuh").read_bytes())
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = kernels.BUILD_DIR / f"micro_host_{h.hexdigest()[:16]}.so"
    if not so.exists():
        src = so.with_suffix(".cpp")
        src.write_text(SHIM)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(
            [gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
             f"-I{kernels.CSRC_DIR}", "-o", str(tmp), str(src)],
            check=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.micro_host_run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 3
    lib.micro_host_run.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("name", NAMES)
def test_host_bodies_match_plain(host_lib, name):
    planes = _torch_planes(mk.make_arrays(LANES), name, LANES)
    want = mk.plain(name, planes, iters=mk.K, block=mk.B)
    got = {k: v.clone() for k, v in planes.items()}
    ptr = {k: got[k].data_ptr() if k in got else None for k in mk.SHAPES}
    assert host_lib.micro_host_run(NAMES.index(name), ptr["mb"], ptr["mem"],
                                   ptr["rows"], ptr["cnt"], LANES, mk.K,
                                   mk.B) == 0
    for k in planes:
        assert torch.equal(got[k], want[k]), k
