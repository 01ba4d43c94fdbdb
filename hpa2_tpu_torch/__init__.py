"""PyTorch/CUDA port of the ensemble fast path of ``hpa2_tpu``.

The package runs the directory-MESI DSM simulator's lockstep ensemble
engine on an NVIDIA GPU: ``hpa2_tpu_torch.ops.cuda_engine.CudaEngine``
is the counterpart of ``hpa2_tpu.ops.pallas_engine.PallasEngine``
(streamed or per-call, with or without the occupancy scheduler), and
``hpa2_tpu_torch.ops.session.CudaLaneSession`` of its resident-lane
session, with hand-written CUDA kernels (``csrc/``).  It imports
neither JAX nor ``hpa2_tpu``; the state planes keep ``hpa2_tpu``'s
layout bit for bit, so the two packages compare plane by plane.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
which runs the plain PyTorch version of the kernel.
"""

from hpa2_tpu_torch.config import Semantics, SystemConfig

__all__ = ["Semantics", "SystemConfig"]
