"""Checkpoint and resume of the general engine's state: the port's own
copy of ``hpa2_tpu/utils/checkpoint.py`` (l.1-387), and the spec
engine's JSON checkpoints.

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

The spec engine's checkpoints (``save_spec_state`` and
``load_spec_state``, l.181-370) are JSON documents of its Python state,
the fault stream's ``random.Random`` state included, in the JAX
package's schema and magic: a file from either package resumes in the
other and finishes byte-identical to the straight run.
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
_SPEC_MAGIC = "hpa2_spec_checkpoint_v1"

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


# -- spec-engine checkpointing (crash-resume) -------------------------
#
# The spec engine is plain Python objects, so its checkpoint is JSON:
# every node's architectural state (memory/directory/cache), the
# mailbox and backpressure queues mid-flight, the engine's schedule
# position, counters, logs, and — critically for fault injection —
# the exact ``random.Random`` state of the link-layer PRNG, so a run
# killed at cycle N and resumed continues on the *same* fault stream
# and finishes byte-identical to an uninterrupted run.


def _msg_to_list(m) -> list:
    return [int(m.type), m.sender, m.address, m.value, m.sharers,
            m.second_receiver, m.deliver_at]


def _msg_from_list(row) -> "object":
    from hpa2_tpu_torch.models.protocol import Message, MsgType

    # pre-topology checkpoints have 6-element rows (no deliver_at)
    t, sender, address, value, sharers, second = row[:6]
    msg = Message(MsgType(t), sender, address, value, sharers, second)
    if len(row) > 6:
        msg.deliver_at = row[6]
    return msg


def _dump_to_dict(d) -> dict:
    out = {
        "proc_id": d.proc_id,
        "memory": list(d.memory),
        "dir_state": [int(s) for s in d.dir_state],
        "dir_sharers": list(d.dir_sharers),
        "cache_addr": list(d.cache_addr),
        "cache_value": list(d.cache_value),
        "cache_state": [int(s) for s in d.cache_state],
    }
    if d.dir_owner is not None:  # owner-plane protocols only
        out["dir_owner"] = list(d.dir_owner)
    return out


def _dump_from_dict(d) -> "object":
    from hpa2_tpu_torch.models.protocol import CacheState, DirState
    from hpa2_tpu_torch.utils.dump import NodeDump

    return NodeDump(
        proc_id=d["proc_id"],
        memory=list(d["memory"]),
        dir_state=[DirState(s) for s in d["dir_state"]],
        dir_sharers=list(d["dir_sharers"]),
        cache_addr=list(d["cache_addr"]),
        cache_value=list(d["cache_value"]),
        cache_state=[CacheState(s) for s in d["cache_state"]],
        dir_owner=(
            list(d["dir_owner"]) if d.get("dir_owner") is not None
            else None
        ),
    )


def save_spec_state(path: str, engine) -> None:
    """Atomically serialize a ``SpecEngine`` mid-run to ``path``
    (JSON).  Checkpoint at a cycle boundary (between ``step()`` calls);
    ``load_spec_state`` rebuilds an engine that continues
    bit-identically, fault stream included."""
    if engine._outbox:
        raise ValueError(
            "checkpoint only at a cycle boundary (outbox not drained)"
        )
    doc = {
        "magic": _SPEC_MAGIC,
        "config": json.loads(_config_to_json(engine.config)),
        "cycle": engine.cycle,
        "order_pos": engine.order_pos,
        "replay_batched": engine.replay_batched,
        "replay_order": (
            None if engine.replay_order is None
            else [dataclasses.astuple(r) for r in engine.replay_order]
        ),
        "counters": dict(engine.counters),
        "max_mailbox_depth": engine.max_mailbox_depth,
        "issue_log": [dataclasses.astuple(r) for r in engine.issue_log],
        "trace_msgs": engine.trace_msgs,
        "msg_log": list(engine.msg_log),
        "debug_invariants": engine.debug_invariants,
        "last_activity_cycle": engine.last_activity_cycle,
        "recent_msgs": [list(e) for e in engine.recent_msgs.entries()],
        "fault_rng": (
            None if engine._fault_rng is None
            else list(engine._fault_rng.getstate())
        ),
        "link_tracker": (
            None if engine.link_tracker is None
            else engine.link_tracker.dump_state()
        ),
        "nodes": [
            {
                "memory": list(n.memory),
                # 3-element rows carry the tracked owner pointer; the
                # loader accepts legacy 2-element (pre-protocol) rows
                "dir": [[int(e.state), e.sharers, e.owner]
                        for e in n.directory],
                "cache": [[l.address, l.value, int(l.state)]
                          for l in n.cache],
                "trace": [[i.op, i.address, i.value] for i in n.trace],
                "pc": n.pc,
                "waiting": n.waiting,
                "pending_write": n.pending_write,
                "mailbox": [_msg_to_list(m) for m in n.mailbox],
                "pending_sends": [
                    [ph, rcv, _msg_to_list(m)]
                    for ph, rcv, m in n.pending_sends
                ],
                "dumped": n.dumped,
                "snapshot": (
                    None if n.snapshot is None
                    else _dump_to_dict(n.snapshot)
                ),
                "dump_candidates": [
                    _dump_to_dict(d) for d in n.dump_candidates
                ],
            }
            for n in engine.nodes
        ],
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def load_spec_state(path: str):
    """Rebuild the ``SpecEngine`` saved by ``save_spec_state``."""
    from hpa2_tpu_torch.models.protocol import CacheState, DirState, Instr
    from hpa2_tpu_torch.models.spec_engine import SpecEngine
    from hpa2_tpu_torch.utils.trace import IssueRecord

    with open(path) as f:
        doc = json.load(f)
    if doc.get("magic") != _SPEC_MAGIC:
        raise ValueError(f"{path}: not a hpa2 spec checkpoint")
    config = _config_from_json(json.dumps(doc["config"]))
    traces = [
        [Instr(op, addr, val) for op, addr, val in nd["trace"]]
        for nd in doc["nodes"]
    ]
    engine = SpecEngine(
        config,
        traces,
        replay_order=(
            None if doc["replay_order"] is None
            else [IssueRecord(*row) for row in doc["replay_order"]]
        ),
        replay_batched=doc["replay_batched"],
        trace_msgs=doc["trace_msgs"],
        debug_invariants=doc["debug_invariants"],
    )
    engine.cycle = doc["cycle"]
    engine.order_pos = doc["order_pos"]
    engine.counters.update(doc["counters"])
    engine.max_mailbox_depth = doc["max_mailbox_depth"]
    engine.issue_log = [IssueRecord(*row) for row in doc["issue_log"]]
    engine.msg_log = list(doc["msg_log"])
    engine.last_activity_cycle = doc["last_activity_cycle"]
    for entry in doc["recent_msgs"]:
        engine.recent_msgs.push(tuple(entry))
    if doc["fault_rng"] is not None:
        st = doc["fault_rng"]
        engine._fault_rng.setstate((st[0], tuple(st[1]), st[2]))
    if doc.get("link_tracker") is not None:
        engine.link_tracker.load_state(doc["link_tracker"])
    for node, nd in zip(engine.nodes, doc["nodes"]):
        node.memory = list(nd["memory"])
        for entry, row in zip(node.directory, nd["dir"]):
            entry.state = DirState(row[0])
            entry.sharers = row[1]
            # pre-protocol checkpoints have 2-element rows (no owner)
            entry.owner = row[2] if len(row) > 2 else -1
        for line, (addr, val, cs) in zip(node.cache, nd["cache"]):
            line.address = addr
            line.value = val
            line.state = CacheState(cs)
        node.pc = nd["pc"]
        node.waiting = nd["waiting"]
        node.pending_write = nd["pending_write"]
        node.mailbox.clear()
        node.mailbox.extend(_msg_from_list(r) for r in nd["mailbox"])
        node.pending_sends = [
            (ph, rcv, _msg_from_list(m))
            for ph, rcv, m in nd["pending_sends"]
        ]
        node.dumped = nd["dumped"]
        node.snapshot = (
            None if nd["snapshot"] is None
            else _dump_from_dict(nd["snapshot"])
        )
        node.dump_candidates = [
            _dump_from_dict(d) for d in nd["dump_candidates"]
        ]
    return engine


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
