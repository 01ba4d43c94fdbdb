"""The engines of the port.

* The fast path: state layout, the plain PyTorch cycle and runs, the
  CUDA kernels' build and binding, the occupancy scheduler, the engine
  (``cuda_engine.CudaEngine``) and the resident-lane session.
* The general engine, the port of ``hpa2_tpu.ops``' XLA family
  (``state``, ``step``, ``engine``): every protocol, directory format,
  topology and link fault, cycle elision, replay and the watchdog, as
  PyTorch on tensors.  Its names are the JAX package's, with
  ``TorchEngine``/``BatchTorchEngine`` for ``JaxEngine``/
  ``BatchJaxEngine``.
"""

import importlib

#: exported name -> its module (imported on first use: the submodules
#: import each other and ``convert.py``, so the package stays light)
_EXPORTS = {
    "BatchTorchEngine": "engine",
    "StallDiagnostic": "engine",
    "TorchEngine": "engine",
    "build_batched_run": "engine",
    "engine_stats": "engine",
    "link_stats": "engine",
    "stall_diagnostic": "engine",
    "SimState": "state",
    "init_state": "state",
    "init_state_batched": "state",
    "stack_states": "state",
    "build_elided_body": "step",
    "build_fast_forward": "step",
    "build_propose": "step",
    "build_run": "step",
    "build_step": "step",
    "quiescent": "step",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
