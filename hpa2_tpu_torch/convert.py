"""State carried across packages.

* The fast path's planes as a dict of numpy arrays (the form
  ``hpa2_tpu``'s ``_init_state`` returns, or ``np.asarray`` of its
  engine planes) to and from this package's tensors.  The word layouts
  are identical, so this is a copy.  Planes are int32, except packed
  planes, which keep their u8/u16 types.
* The general engine's ``SimState``: a JAX ``SimState`` as numpy arrays
  (a dict, or the NamedTuple itself) to the port's ``SimState`` and
  back.  The port's state always has a batch axis; an unbatched JAX
  state (one system, ``JaxEngine``) is a batch of one.  The uint32
  fields (``dir_sharers``, ``ob_sharers``, ``snap_dir_sharers``,
  ``rng_key``) are carried as int32 tensors of the same bits.
"""

from __future__ import annotations

from typing import Dict, Mapping

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


def sim_state_from_numpy(st, device="cuda", batched: bool = True):
    """A JAX ``SimState`` (the NamedTuple or a mapping of its fields,
    any array type numpy can read) -> the port's ``SimState`` on
    ``device``.  ``batched=False`` takes one system's state (scalar
    counters) and adds the batch axis."""
    from hpa2_tpu_torch.ops.state import SimState

    d = st if isinstance(st, Mapping) else st._asdict()
    out = {}
    for f in SimState._fields:
        a = np.array(d[f], copy=True)
        if not batched:
            a = a[None]
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        elif a.dtype not in (np.int32, np.bool_):
            raise ValueError(
                f"SimState field {f!r} is {a.dtype}, expected int32, "
                "uint32 or bool")
        out[f] = torch.from_numpy(a).to(device)
    return SimState(**out)


def sim_state_to_numpy(st, batched: bool = True) -> Dict[str, np.ndarray]:
    """The port's ``SimState`` -> a dict of numpy arrays with the JAX
    field types (uint32 words back as uint32).  ``batched=False`` drops
    the batch axis of a batch of one."""
    from hpa2_tpu_torch.ops.state import U32_FIELDS

    out = {}
    for f, v in st._asdict().items():
        a = v.detach().cpu().numpy()
        if not batched:
            if a.shape[0] != 1:
                raise ValueError(
                    f"batched=False needs a batch of one, got {a.shape[0]}")
            a = a[0]
        if f in U32_FIELDS:
            a = a.view(np.uint32)
        out[f] = a
    return out
