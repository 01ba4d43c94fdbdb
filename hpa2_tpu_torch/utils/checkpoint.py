"""Checkpoint and resume of the general engine's state: the port's own
copy of ``hpa2_tpu/utils/checkpoint.py`` (l.1-180, 373-387).

A checkpoint is one compressed ``.npz``: every ``SimState`` field as
``f_<field>``, plus ``meta_magic``, ``meta_version``, ``meta_config``
(the ``SystemConfig`` as JSON) and ``meta_extra`` (JSON workload and
serving metadata, checked on resume so a stale checkpoint from another
run is not silently continued).  Schema v2 carries the recovery
counters under ``extra["recovery"]``; a v1 file loads with them
zero-filled, and a file that predates a telemetry counter of
``_ZERO_BACKFILL`` loads with that counter at zero (``n_msgs``'s
shape).

**The files are the JAX package's files.**  Each field is written with
the JAX type: the uint32 words (sharers, keys) go through
``convert.sim_state_to_numpy`` and bools stay bools.  A state saved with
``batched=False`` (a batch of one) drops the batch axis, as ``JaxEngine``
writes it, and a file without one loads as a batch of one.  So a
checkpoint written by either package resumes in the other, and the
resumed run continues bit for bit.

The spec engine's JSON checkpoints (``save_spec_state`` and
``load_spec_state``, l.231-370) wait for the spec engine (ROADMAP queue
1 item 5).
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Optional

import numpy as np

from hpa2_tpu_torch.config import (
    FailureEvent,
    FailurePlan,
    FaultModel,
    InterconnectConfig,
    Semantics,
    SystemConfig,
)

_MAGIC = "hpa2_checkpoint_v1"

#: metadata schema: v2 adds the recovery counters to
#: ``extra_meta["recovery"]``
_META_VERSION = 2

#: supervisor recovery counters carried in checkpoint metadata since
#: schema v2; absent (= zero) in every older checkpoint
RECOVERY_COUNTERS = ("migrations", "evacuations", "shed_jobs", "retries")

#: telemetry counters that may be absent from older checkpoints,
#: zero-filled on load with ``n_msgs``'s shape (every
#: only-when-nonzero counter ``engine_stats`` reads)
_ZERO_BACKFILL = frozenset({
    # fault layer
    "n_retrans", "n_dup_filtered", "n_reorder_fixed", "n_delays",
    "n_wire_stalls",
    # interconnect topology
    "n_topo_delay", "n_multicast_saved", "n_combined",
    # cycle elision
    "n_elided", "n_multi_hit",
    # protocol variants
    "n_forwards", "n_owner_xfer", "n_dir_overflow",
    # cross-shard exchange
    "n_exch_sent", "n_exch_hwm", "n_exch_mc_saved", "n_exch_combined",
})


def _config_to_json(config: SystemConfig) -> str:
    return json.dumps(dataclasses.asdict(config))


def _config_from_json(text: str) -> SystemConfig:
    d = json.loads(text)
    d["semantics"] = Semantics(**d["semantics"])
    if d.get("fault") is not None:
        d["fault"] = FaultModel(**d["fault"])
    if "interconnect" in d:  # absent in pre-topology checkpoints
        ic = dict(d["interconnect"])
        ic["fault"] = FaultModel(**ic["fault"])
        d["interconnect"] = InterconnectConfig(**ic)
    if d.get("failures") is not None:
        fp = dict(d["failures"])
        fp["events"] = tuple(
            FailureEvent(**ev) for ev in fp.get("events", ())
        )
        d["failures"] = FailurePlan(**fp)
    return SystemConfig(**d)


def _with_recovery(extra: dict) -> dict:
    """``extra`` with every recovery counter present (zero-defaulted)."""
    rec = dict(extra.get("recovery") or {})
    for name in RECOVERY_COUNTERS:
        rec.setdefault(name, 0)
    extra["recovery"] = rec
    return extra


def save_state(
    path: str,
    state,
    config: SystemConfig,
    extra_meta: Optional[dict] = None,
    batched: bool = True,
) -> None:
    """Atomically write a state (the port's ``SimState`` on any device),
    its config and JSON-able metadata to ``path`` (.npz), in the JAX
    package's format.  ``batched=False`` writes a batch of one as one
    system's state."""
    from hpa2_tpu_torch.convert import sim_state_to_numpy

    arrays = {
        f"f_{name}": leaf
        for name, leaf in sim_state_to_numpy(state, batched=batched).items()
    }
    arrays["meta_magic"] = np.array(_MAGIC)
    arrays["meta_version"] = np.array(_META_VERSION)
    arrays["meta_config"] = np.array(_config_to_json(config))
    extra = _with_recovery(dict(extra_meta or {}))
    arrays["meta_extra"] = np.array(json.dumps(extra))
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)  # atomic: a crash never leaves a torn file


def load_state(path: str, with_meta: bool = False, device="cuda"):
    """-> (state, config) or, with ``with_meta``, (state, config,
    extra_meta dict); the state is the port's (always batched) on
    ``device``, which is the card unless the caller asks for the
    CPU."""
    from hpa2_tpu_torch.convert import sim_state_from_numpy
    from hpa2_tpu_torch.ops.cuda_engine import resolve_device
    from hpa2_tpu_torch.ops.state import SimState

    dev = resolve_device(device)
    with np.load(path) as z:
        if str(z["meta_magic"]) != _MAGIC:
            raise ValueError(f"{path}: not a hpa2 checkpoint")
        version = int(z["meta_version"]) if "meta_version" in z else 1
        if version > _META_VERSION:
            raise ValueError(
                f"{path}: checkpoint schema v{version} is newer than "
                f"this build's v{_META_VERSION}"
            )
        config = _config_from_json(str(z["meta_config"]))
        extra = json.loads(str(z["meta_extra"])) if "meta_extra" in z else {}
        extra = _with_recovery(extra)
        leaves = {}
        for name in SimState._fields:
            key = f"f_{name}"
            if key in z:
                leaves[name] = z[key]
            elif name in _ZERO_BACKFILL:
                # a counter added after the checkpoint was written
                leaves[name] = np.zeros_like(z["f_n_msgs"])
            else:
                raise ValueError(
                    f"{path}: missing field {name} (incompatible "
                    "checkpoint version)"
                )
    batched = leaves["n_msgs"].ndim == 1
    state = sim_state_from_numpy(leaves, device=dev, batched=batched)
    if with_meta:
        return state, config, extra
    return state, config


def latest_checkpoint(directory: str, stem: str = "ckpt") -> Optional[str]:
    """Highest-numbered ``<stem>_<n>.npz`` in ``directory`` (or None)."""
    best, best_n = None, -1
    if not os.path.isdir(directory):
        return None
    for name in os.listdir(directory):
        if not (name.startswith(stem + "_") and name.endswith(".npz")):
            continue
        try:
            n = int(name[len(stem) + 1:-4])
        except ValueError:
            continue
        if n > best_n:
            best, best_n = os.path.join(directory, name), n
    return best
