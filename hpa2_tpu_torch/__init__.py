"""PyTorch/CUDA port of ``hpa2_tpu``, the directory-MESI DSM simulator.

Two engines, each with the observable behaviour of its JAX counterpart:

* the ensemble fast path: ``hpa2_tpu_torch.ops.cuda_engine.CudaEngine``
  is the counterpart of ``hpa2_tpu.ops.pallas_engine.PallasEngine``
  (streamed or per-call, with or without the occupancy scheduler), and
  ``hpa2_tpu_torch.ops.session.CudaLaneSession`` of its resident-lane
  session, with hand-written CUDA kernels (``csrc/``); its state planes
  keep ``hpa2_tpu``'s layout bit for bit;
* the general engine: ``hpa2_tpu_torch.ops.engine.TorchEngine`` and
  ``BatchTorchEngine``, the counterparts of ``JaxEngine`` and
  ``BatchJaxEngine``, which run what the fast path refuses (MOESI and
  MESIF, the limited and coarse directories, non-ideal topologies,
  link faults) with cycle elision, replay and the stall watchdog, with
  or without the occupancy scheduler, and ``BatchLaneSession`` of its
  resident-row session; its ``SimState`` carries the JAX state's fields
  (``convert.py``) and its checkpoints are the JAX package's files
  (``utils/checkpoint.py``).

Both serve jobs (``serving/``: ``backend="pallas"`` or ``"jax"``), under
the recovery supervisor when asked (``serving/recovery.py``).  Beside
them run the host engines: the executable spec
(``models/spec_engine.py``, with its JSON checkpoints) and the
C++/OpenMP engine of ``native/`` (``native.py``, built into
``hpa2_tpu_torch/build/native/``).  ``python -m hpa2_tpu_torch`` is the
command line (``run``, ``bench``, ``serve`` with every backend) and
``python -m hpa2_tpu_torch.bench`` the benchmark harness.

It imports neither JAX nor ``hpa2_tpu``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"`` (the fast path then runs its
kernels' plain PyTorch versions).
"""

from hpa2_tpu_torch.config import Semantics, SystemConfig

__all__ = ["Semantics", "SystemConfig"]
