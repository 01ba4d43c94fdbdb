"""Fixture-parity harness: replay a recorded run and diff against fixtures.

A fixture *run set* is a directory holding ``core_<n>_output.txt`` for
every node plus the ``instruction_order.txt`` that produced it
(SURVEY.md §4).  Deterministic suites (sample, test_1, test_2) keep
these next to the traces; nondeterministic suites ship several run sets
(test_3/run_1..2, test_4/run_1..4).

The port's copy of ``hpa2_tpu/utils/parity.py`` (l.1-119), over the
port's own spec engine.
"""

from __future__ import annotations

import difflib
import os
from typing import Dict, List, Optional, Sequence, Tuple

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.models.spec_engine import SpecEngine
from hpa2_tpu_torch.utils.dump import NodeDump, format_processor_state
from hpa2_tpu_torch.utils.trace import load_instruction_order, load_trace_dir


def discover_run_sets(suite_dir: str) -> List[str]:
    """Directories containing fixture dumps + instruction_order.txt."""
    runs = sorted(
        os.path.join(suite_dir, d)
        for d in os.listdir(suite_dir)
        if d.startswith("run_") and os.path.isdir(os.path.join(suite_dir, d))
    )
    return runs if runs else [suite_dir]


def replay_run_set(
    suite_dir: str,
    run_dir: str,
    config: SystemConfig,
    engine_cls=SpecEngine,
    batched: bool = False,
):
    """Replay one run set with any parity-capable engine.

    SpecEngine captures dump candidates natively; JaxEngine does so via
    its cycle-stepping ``run_capturing_candidates`` mode.
    """
    traces = load_trace_dir(suite_dir, config)
    order = load_instruction_order(os.path.join(run_dir, "instruction_order.txt"))
    if issubclass(engine_cls, SpecEngine):
        engine = engine_cls(
            config, traces, replay_order=order, replay_batched=batched
        )
        engine.run()
    else:
        if batched:
            raise ValueError("batched replay is a SpecEngine-only mode")
        engine = engine_cls(config, traces, replay_order=order)
        engine.run_capturing_candidates()
    return engine


def engine_candidates(engine, node_id: int) -> List[NodeDump]:
    """Legal dump-timing candidates for one node, engine-agnostic."""
    if hasattr(engine, "nodes"):  # SpecEngine
        return list(engine.nodes[node_id].dump_candidates)
    return list(engine.dump_candidates[node_id])  # JaxEngine


def diff_against_fixtures(
    engine: SpecEngine,
    run_dir: str,
    config: SystemConfig,
    allow_candidates: bool = True,
) -> Dict[int, str]:
    """Return {node_id: unified diff} for every mismatching node.

    With ``allow_candidates`` a node matches if *any* of its legal
    dump-timing candidates (see ``Node.dump_candidates``) reproduces
    the fixture byte-exactly — the reference's dump moment is
    OS-scheduling-dependent, so the fixture pins one of several legal
    snapshots.  The reported diff is against the earliest (canonical)
    snapshot.
    """
    diffs: Dict[int, str] = {}
    snapshots = None  # lazy: only needed when a node has no candidates
    for node_id in range(config.num_procs):
        path = os.path.join(run_dir, f"core_{node_id}_output.txt")
        with open(path, "r") as f:
            expected = f.read()
        candidates = engine_candidates(engine, node_id) if allow_candidates else []
        if not candidates:
            if snapshots is None:
                snapshots = engine.snapshots()
            candidates = [snapshots[node_id]]
        rendered = [format_processor_state(c, config) for c in candidates]
        if expected not in rendered:
            diffs[node_id] = "".join(
                difflib.unified_diff(
                    expected.splitlines(keepends=True),
                    rendered[0].splitlines(keepends=True),
                    fromfile=f"fixture/{os.path.basename(run_dir)}/core_{node_id}",
                    tofile="engine",
                )
            )
    return diffs


def check_suite(
    suite_dir: str,
    config: SystemConfig,
    engine_cls=SpecEngine,
    batched: bool = False,
    allow_candidates: bool = True,
) -> Dict[str, Dict[int, str]]:
    """Replay every run set of a suite; return {run_dir: diffs}."""
    results = {}
    for run_dir in discover_run_sets(suite_dir):
        engine = replay_run_set(suite_dir, run_dir, config, engine_cls, batched)
        results[run_dir] = diff_against_fixtures(
            engine, run_dir, config, allow_candidates
        )
    return results
