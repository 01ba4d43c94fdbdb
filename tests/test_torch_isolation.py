"""The port stands alone: no module of ``hpa2_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, the JAX package or the native engine;
its entry points run on the card unless told otherwise; and the kernel
wrapper refuses planes it cannot take instead of running them."""

import ast
import inspect
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from hpa2_tpu_torch.config import Semantics, SystemConfig
from hpa2_tpu_torch.convert import state_from_numpy
from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
from hpa2_tpu_torch.ops.layout import _init_state, _pack_traces
from hpa2_tpu_torch.scripts import micro_kernels
from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO_ROOT / "hpa2_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "hpa2_tpu", "native"}


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "__import__", "import_module"):
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(
                        arg.value, str):
                    yield arg.value.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 10
    offenders = {
        str(p.relative_to(REPO_ROOT)): sorted(set(_imported_roots(p))
                                              & FORBIDDEN)
        for p in sources
    }
    assert {k: v for k, v in offenders.items() if v} == {}


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import hpa2_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "hpa2_tpu_torch.__path__, 'hpa2_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO_ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(REPO_ROOT), timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 12


def _small():
    cfg = SystemConfig(msg_buffer_size=16, semantics=Semantics().robust())
    return cfg, gen_uniform_random_arrays(cfg, 2, 4, seed=0)


def test_engine_defaults_to_the_card():
    cfg, arrays = _small()
    if torch.cuda.is_available():
        assert CudaEngine(cfg, *arrays).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CudaEngine(cfg, *arrays)


def test_serve_defaults_to_the_card():
    from hpa2_tpu_torch.serving import (
        ListJobSource, build_serving, serve, synthetic_jobs,
    )

    params = inspect.signature(build_serving).parameters
    assert params["device"].default == "cuda"
    cfg, _ = _small()
    jobs = synthetic_jobs(cfg, 2, 4, seed=0)
    if torch.cuda.is_available():
        drv = build_serving(cfg, ListJobSource(jobs), resident=2)
        assert drv.session.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve(cfg, ListJobSource(jobs), resident=2)


def test_micro_kernels_runner_defaults_to_the_card():
    assert inspect.signature(micro_kernels.main).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            micro_kernels.main()


def _planes(cfg, arrays):
    state = state_from_numpy(_init_state(cfg, 2, False), "cpu")
    tr = torch.from_numpy(_pack_traces(cfg, *arrays))
    tr_len = torch.from_numpy(np.ascontiguousarray(arrays[3].T))
    return state, tr, tr_len


KW = dict(block=2, k=8, window=4, n_seg=1, max_calls=100, gate=True,
          snapshots=False)


def test_plain_run_counts_no_launch():
    cfg, arrays = _small()
    state, tr, tr_len = _planes(cfg, arrays)
    before = kernels.STREAM_RUN.launches
    status = kernels.stream_run(cfg, state, tr, tr_len, **KW)
    assert kernels.STREAM_RUN.launches == before
    assert status.shape == (1, 2) and not status.any()
    assert int(state["scalars"][1].sum()) == 2 * 4 * 4


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguity", "block"])
def test_wrapper_refuses_bad_planes(fault):
    cfg, arrays = _small()
    state, tr, tr_len = _planes(cfg, arrays)
    kw = dict(KW)
    if fault == "dtype":
        state["nsw"] = state["nsw"].long()
    elif fault == "shape":
        state["mb0"] = state["mb0"][:, :8].contiguous()
    elif fault == "contiguity":
        state["dirw"] = state["dirw"].transpose(1, 2).contiguous(
        ).transpose(1, 2)
    else:
        kw["block"] = 3
    with pytest.raises(ValueError):
        kernels.stream_run(cfg, state, tr, tr_len, **kw)
