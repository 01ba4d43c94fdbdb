"""State carried across packages: the fast path's planes as a dict of
numpy arrays (the form ``hpa2_tpu``'s ``_init_state`` returns, or
``np.asarray`` of its engine planes) to and from this package's
tensors.  The word layouts are identical, so this is a copy.  Planes
are int32, except packed planes, which keep their u8/u16 types."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from hpa2_tpu_torch.ops.layout import TORCH_DTYPES


def state_from_numpy(d: Dict[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    """numpy planes -> contiguous tensors of the same type on ``device``
    (always a copy: the engines update their planes in place)."""
    out = {}
    for f, v in d.items():
        a = np.asarray(v)
        if a.dtype not in TORCH_DTYPES:
            raise ValueError(
                f"plane {f!r} is {a.dtype}, expected int32, uint8 or uint16")
        out[f] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return out


def state_to_numpy(d: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Tensors (any device) -> numpy planes of the same type."""
    return {f: v.detach().cpu().numpy() for f, v in d.items()}
