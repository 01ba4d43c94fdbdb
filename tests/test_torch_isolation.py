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


def test_general_serving_and_checkpoints_default_to_the_card(tmp_path):
    """The general engine's lane session, its serving backend, the
    recovery supervisor and checkpoint loading run on the card unless
    told otherwise, and raise without one."""
    from hpa2_tpu_torch.ops.engine import BatchLaneSession
    from hpa2_tpu_torch.ops.state import init_state
    from hpa2_tpu_torch.serving import (
        ListJobSource, serve, supervised_serve, synthetic_jobs,
    )
    from hpa2_tpu_torch.utils.checkpoint import load_state, save_state

    for fn in (BatchLaneSession, load_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    cfg, _ = _small()
    path = str(tmp_path / "ck.npz")
    save_state(path, init_state(cfg, [[]] * cfg.num_procs, device="cpu"),
               cfg)
    jobs = synthetic_jobs(cfg, 2, 4, seed=0)
    calls = (
        lambda: BatchLaneSession(cfg, 2, 4),
        lambda: serve(cfg, ListJobSource(jobs), backend="jax", resident=2),
        lambda: supervised_serve(cfg, ListJobSource(jobs), backend="jax",
                                 resident=2),
        lambda: load_state(path),
    )
    for call in calls:
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


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


def test_entry_points_default_to_the_card(tmp_path):
    """The bench harness's studies and the CLI's device backends run on
    the card unless told otherwise, and raise without one; the spec and
    omp backends are host engines and run either way."""
    from hpa2_tpu_torch import bench, cli

    for fn in (bench.headline_main, bench.serve_main, bench.failover_main,
               bench.topo_main, bench.protocol_main, bench.bench_pallas,
               bench.bench_jax, bench.fault_counters):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    small = ["--batch", "2", "--instrs", "4", "--robust"]
    calls = [lambda: bench.main(["--topology"]),
             lambda: cli.main(["bench", "--backend", "pallas", *small]),
             lambda: cli.main(["bench", "--backend", "jax", *small])]
    for call in calls:
        if torch.cuda.is_available():
            continue
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    for backend in ("spec", "omp"):
        assert cli.main(["bench", "--backend", backend, "--instrs", "4",
                         "--robust"]) == 0


def test_native_engine_builds_into_the_port():
    """The OpenMP baseline is built from ``native/src`` into the port's
    own build folder, never from or into ``native/build``."""
    from hpa2_tpu_torch import native

    assert native.BUILD_DIR == PORT / "build" / "native"
    assert native.library_path().parent == native.BUILD_DIR
    assert native.NATIVE_SRC == REPO_ROOT / "native" / "src"
    tree = ast.parse((PORT / "native.py").read_text())
    strings = [n.value for n in ast.walk(tree)
               if isinstance(n, ast.Constant) and isinstance(n.value, str)
               and len(n.value) < 40]
    assert "make" not in strings and not any(
        "native/build" in s for s in strings)


#: the analysis suite's modules beside the table and checks copies
ANALYSIS_MODULES = ("extract", "mutate", "elision", "vmem", "ir",
                    "contracts", "lint", "__main__", "occupancy",
                    "topology")


def test_analysis_suite_stands_alone():
    """The analysis modules, their pin folder and ``chip_smoke.py``'s
    ``[analysis]`` phase import no JAX and nothing of the JAX package
    or the native engine's Python; the pins are data only."""
    import json

    analysis = PORT / "analysis"
    for name in ANALYSIS_MODULES:
        path = analysis / f"{name}.py"
        assert path.exists(), path
        assert not set(_imported_roots(path)) & FORBIDDEN, path
    pins = sorted((analysis / "contracts").iterdir())
    assert pins and all(p.suffix == ".json" for p in pins)
    for p in pins:
        doc = json.loads(p.read_text())
        assert doc["contract"] == p.stem
    tree = ast.parse((REPO_ROOT / "chip_smoke.py").read_text())
    phase = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                 and n.name == "phase_analysis")
    roots = {a.name.split(".")[0] for n in ast.walk(phase)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(phase)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert roots == {"hpa2_tpu_torch"}


def test_analysis_entry_points_default_to_the_card():
    """The analysis suite's device entry points run on the card unless
    told otherwise, and raise without one."""
    from hpa2_tpu_torch.analysis import contracts, elision, extract, mutate

    for fn in (extract.PallasProber, extract.JaxProber,
               extract.diff_backend, extract.diff_multi_backend,
               contracts.run_contracts, elision.elision_table,
               mutate.run_fuzz):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    sem = Semantics().robust()
    for call in (lambda: extract.PallasProber(sem),
                 lambda: contracts.run_contracts(out=lambda line: None)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
