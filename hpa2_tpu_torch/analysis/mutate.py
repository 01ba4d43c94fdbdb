"""Seeded table mutations: the analyzer's self-test (the port of
``hpa2_tpu/analysis/mutate.py``).

A static analyzer that has never been seen to *fail* proves nothing.
Each mutation below injects one realistic protocol bug into the
declarative table — the kinds of defect the reference implementation
actually shipped (silently unhandled pairs, lost wakeups, wrong fill
sources) — and the self-test asserts the analyzer catches every one,
either statically (``run_static_checks`` errors) or by the spec
equivalence diff.

CLI: ``python -m hpa2_tpu_torch.analysis mutation-test``.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, List, NamedTuple, Optional, Tuple

from hpa2_tpu_torch.config import Semantics
from hpa2_tpu_torch.analysis.table import (
    Emit, Row, TransitionTable, build_table,
)
from hpa2_tpu_torch.analysis.checks import run_static_checks
from hpa2_tpu_torch.analysis.extract import diff_backend


class Mutation(NamedTuple):
    name: str
    description: str
    apply: Callable[[TransitionTable], TransitionTable]


def _swap(table: TransitionTable, key, **changes) -> TransitionTable:
    old = table.row(*key)
    return table.replaced(old, dataclasses.replace(old, **changes))


def _delete(table: TransitionTable, key) -> TransitionTable:
    old = table.row(*key)
    return dataclasses.replace(
        table, rows=[r for r in table.rows if r is not old]
    )


def _append(table: TransitionTable, row: Row) -> TransitionTable:
    return dataclasses.replace(table, rows=list(table.rows) + [row])


MUTATIONS: List[Mutation] = [
    Mutation(
        "swap-next-state",
        "first read of an uncached block grants S instead of EM — the "
        "directory forgets it has an exclusive owner",
        lambda t: _swap(t, ("home", "U", "READ_REQUEST", "any"),
                        next_state="S"),
    ),
    Mutation(
        "delete-row",
        "drop the cache-side INV/match row — invalidations are silently "
        "ignored and stale lines survive",
        lambda t: _delete(t, ("cache", "S", "INV", "match")),
    ),
    Mutation(
        "drop-emission",
        "home handles a READ_REQUEST but never sends the REPLY_RD — "
        "the requester waits forever",
        lambda t: _swap(t, ("home", "U", "READ_REQUEST", "any"), emits=()),
    ),
    Mutation(
        "remove-drop-citation",
        "strip the policy citation from the stale-INV drop — the drop "
        "becomes silent",
        lambda t: _swap(t, ("cache", "S", "INV", "other"), drop=""),
    ),
    Mutation(
        "duplicate-case",
        "claim the same guard-case twice with different outcomes — the "
        "transition relation becomes ambiguous",
        lambda t: _append(
            t, dataclasses.replace(
                t.row("cache", "I", "REPLY_WR", "any"), next_state="E")),
    ),
    Mutation(
        "wrong-receiver",
        "send the read reply to the current owner instead of the "
        "requester",
        lambda t: _swap(t, ("home", "U", "READ_REQUEST", "any"),
                        emits=(Emit("REPLY_RD", "owner", value="mem",
                                    sharers="excl"),)),
    ),
    Mutation(
        "corrupt-sharers",
        "FLUSH_INVACK leaves the directory EM with an empty sharer set "
        "— an owned block with no owner",
        lambda t: _swap(t, ("home", "EM", "FLUSH_INVACK", "any"),
                        sharers="empty"),
    ),
    Mutation(
        "premature-modified",
        "an exclusive read fill installs M instead of E — a clean line "
        "the directory will now ask to flush",
        lambda t: _swap(t, ("cache", "I", "REPLY_RD", "excl"),
                        next_state="M"),
    ),
    Mutation(
        "phantom-emission",
        "the write fill also broadcasts a spurious INV",
        lambda t: _swap(
            t, ("cache", "I", "REPLY_WR", "any"),
            emits=(Emit("INV", "home"),)),
    ),
    Mutation(
        "wrong-fill-source",
        "REPLY_WR fills the line from the (stale) message payload "
        "instead of the requester's pending write",
        lambda t: _swap(t, ("cache", "I", "REPLY_WR", "any"),
                        value_src="msg"),
    ),
    Mutation(
        "contradict-unreachable",
        "add a row in a cell explicitly declared unreachable",
        lambda t: _append(
            t, Row("home", "U", "NACK", "read_intervention",
                   next_state="U")),
    ),
    Mutation(
        "lost-wakeup",
        "REPLY_WR fills the line but never clears the waiting flag — "
        "the classic lost-wakeup hang",
        lambda t: _swap(t, ("cache", "I", "REPLY_WR", "any"),
                        clears_waiting=False),
    ),
]


@dataclasses.dataclass
class MutationResult:
    name: str
    caught: bool
    caught_by: str       # 'static' | 'spec-diff' | ''
    evidence: List[str]  # first few findings / diff lines


def run_mutation(
    mut: Mutation, sem: Semantics, protocol: str = "mesi"
) -> MutationResult:
    table = mut.apply(build_table(sem, protocol))
    static_errors = [
        str(f) for f in run_static_checks(table) if f.severity == "error"
    ]
    if static_errors:
        return MutationResult(mut.name, True, "static", static_errors[:3])
    # statically plausible table — the behavioral diff must object
    mutated_keys = _changed_keys(build_table(sem, protocol), table)
    rows = [r for r in table.rows
            if r.key in mutated_keys and not table.is_unreachable(*r.key)]
    diffs = diff_backend(table, "spec", rows=rows or None)
    if diffs:
        return MutationResult(mut.name, True, "spec-diff", diffs[:3])
    return MutationResult(mut.name, False, "", [])


def _changed_keys(base: TransitionTable, mutated: TransitionTable):
    base_rows = {r.key: r for r in base.rows}
    return {
        r.key for r in mutated.rows
        if base_rows.get(r.key) != r
    }


def run_all_mutations(
    sem: Semantics = None, protocol: str = "mesi"
) -> List[MutationResult]:
    sem = sem if sem is not None else Semantics()
    return [run_mutation(m, sem, protocol) for m in MUTATIONS]


# ---------------------------------------------------------------------------
# seeded cross-protocol fuzzing.  The curated set above encodes twelve
# KNOWN defect shapes; the fuzzer samples the space between them: it
# draws a random probeable row from any protocol's table and applies a
# random surgical corruption chosen to be semantically visible (the
# generators reject identity rewrites, e.g. a sharer update whose
# resolution equals the original under the probe scenario).  Every
# sample must be caught — statically, by the spec probe diff, or by
# the JAX probe diff — so the assertion is the same as the curated
# set's, over hundreds of machine-chosen bugs per protocol.
# ---------------------------------------------------------------------------

_FUZZ_EMIT_TYPES = (
    "REPLY_RD", "REPLY_WR", "REPLY_ID", "INV", "WRITEBACK_INT",
    "WRITEBACK_INV", "UPGRADE_NOTIFY", "FLUSH", "FLUSH_INVACK",
)
_FUZZ_FILLS = ("msg", "pending", "instr", "placeholder")
_FUZZ_SHARERS = ("empty", "requester", "+requester", "-sender", "same")
_FUZZ_OWNERS = ("none", "requester", "same", "second")


def _fuzz_next_state(
    rng: random.Random, table: TransitionTable, row: Row
) -> Optional[Row]:
    states = (table.home_states if row.role == "home"
              else table.cache_states)
    choices = [s for s in states if s != row.next_state]
    if row.drop or not choices:
        return None
    return dataclasses.replace(row, next_state=rng.choice(choices))


def _fuzz_drop_emits(
    rng: random.Random, table: TransitionTable, row: Row
) -> Optional[Row]:
    if not row.emits:
        return None
    return dataclasses.replace(row, emits=())


def _fuzz_emit_type(
    rng: random.Random, table: TransitionTable, row: Row
) -> Optional[Row]:
    if not row.emits:
        return None
    i = rng.randrange(len(row.emits))
    e = row.emits[i]
    new_type = rng.choice([t for t in _FUZZ_EMIT_TYPES if t != e.type])
    emits = list(row.emits)
    emits[i] = dataclasses.replace(e, type=new_type)
    return dataclasses.replace(row, emits=tuple(emits))


def _fuzz_fill_source(
    rng: random.Random, table: TransitionTable, row: Row
) -> Optional[Row]:
    if row.role != "cache" or not row.value_src:
        return None
    return dataclasses.replace(
        row, value_src=rng.choice(
            [f for f in _FUZZ_FILLS if f != row.value_src]))


def _fuzz_lost_wakeup(
    rng: random.Random, table: TransitionTable, row: Row
) -> Optional[Row]:
    if not row.clears_waiting:
        return None
    return dataclasses.replace(row, clears_waiting=False)


def _fuzz_forget_memory(
    rng: random.Random, table: TransitionTable, row: Row
) -> Optional[Row]:
    if not row.writes_memory:
        return None
    return dataclasses.replace(row, writes_memory=False)


def _fuzz_sharers(
    rng: random.Random, table: TransitionTable, row: Row
) -> Optional[Row]:
    from hpa2_tpu_torch.analysis.extract import _resolve_sharers, scenario_for

    if row.role != "home" or row.drop:
        return None
    scn = scenario_for(row, table.protocol)
    old = _resolve_sharers(row.sharers, scn.dir_sharers, scn.msg_second)
    choices = [
        s for s in _FUZZ_SHARERS
        if _resolve_sharers(s, scn.dir_sharers, scn.msg_second) != old
    ]
    if not choices:
        return None
    return dataclasses.replace(row, sharers=rng.choice(choices))


def _fuzz_owner(
    rng: random.Random, table: TransitionTable, row: Row
) -> Optional[Row]:
    from hpa2_tpu_torch.protocols.compiler import planes_for
    from hpa2_tpu_torch.analysis.extract import _resolve_owner, scenario_for

    if row.role != "home" or row.drop:
        return None
    if not planes_for(table.protocol, table.semantics).has_owner_plane:
        return None
    scn = scenario_for(row, table.protocol)
    old = _resolve_owner(row.owner, scn)
    choices = [s for s in _FUZZ_OWNERS
               if _resolve_owner(s, scn) != old]
    if not choices:
        return None
    return dataclasses.replace(row, owner=rng.choice(choices))


def _fuzz_delete(
    rng: random.Random, table: TransitionTable, row: Row
) -> Optional[Row]:
    return None  # sentinel handled in random_mutation (row removal)


_FUZZ_KINDS: List[Tuple[str, Callable]] = [
    ("next-state", _fuzz_next_state),
    ("drop-emits", _fuzz_drop_emits),
    ("emit-type", _fuzz_emit_type),
    ("fill-source", _fuzz_fill_source),
    ("lost-wakeup", _fuzz_lost_wakeup),
    ("forget-memory", _fuzz_forget_memory),
    ("sharers-update", _fuzz_sharers),
    ("owner-update", _fuzz_owner),
    ("delete-row", _fuzz_delete),
]


def random_mutation(
    rng: random.Random, table: TransitionTable, max_tries: int = 64
) -> Tuple[str, TransitionTable]:
    """One random visible corruption of ``table`` (name, mutated)."""
    candidates = [r for r in table.rows
                  if not table.is_unreachable(*r.key)]
    for _ in range(max_tries):
        row = rng.choice(candidates)
        kind, gen = _FUZZ_KINDS[rng.randrange(len(_FUZZ_KINDS))]
        name = f"{kind}@{'/'.join(row.key)}"
        if kind == "delete-row":
            if row.drop:
                continue  # deleting a drop row may be a silent no-op
            return name, dataclasses.replace(
                table, rows=[r for r in table.rows if r is not row])
        new = gen(rng, table, row)
        if new is None or new == row:
            continue
        return name, table.replaced(row, new)
    raise RuntimeError("no applicable mutation found (table too small?)")


def run_fuzz(
    sem: Semantics,
    protocol: str = "mesi",
    seed: int = 0,
    count: int = 100,
    with_jax: bool = True,
    device="cuda",
) -> List[MutationResult]:
    """``count`` seeded random corruptions of one protocol's table;
    each must be caught statically or by a backend probe diff (the
    ``jax`` prober, the general engine's step, runs on ``device``)."""
    from hpa2_tpu_torch.analysis.extract import JaxProber

    rng = random.Random(seed)
    base = build_table(sem, protocol)
    prober = JaxProber(sem, protocol, device=device) if with_jax else None
    results = []
    for _ in range(count):
        name, table = random_mutation(rng, base)
        static_errors = [
            str(f) for f in run_static_checks(table)
            if f.severity == "error"
        ]
        if static_errors:
            results.append(
                MutationResult(name, True, "static", static_errors[:3]))
            continue
        mutated_keys = _changed_keys(base, table)
        rows = [r for r in table.rows
                if r.key in mutated_keys
                and not table.is_unreachable(*r.key)]
        diffs = diff_backend(table, "spec", rows=rows or None)
        if diffs:
            results.append(
                MutationResult(name, True, "spec-diff", diffs[:3]))
            continue
        if prober is not None:
            diffs = diff_backend(
                table, "jax", rows=rows or None, prober=prober)
            if diffs:
                results.append(
                    MutationResult(name, True, "jax-diff", diffs[:3]))
                continue
        results.append(MutationResult(name, False, "", []))
    return results
