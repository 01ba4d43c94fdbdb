"""The port's static protocol analysis suite (the port of
``hpa2_tpu/analysis``): the declarative transition table, whole-table
checks, cross-backend equivalence extraction, the analyzer's
self-test, models of the fast path's CTA budget, the scheduler's
occupancy and cycle elision, program contracts and a lint.

* ``table``     -- the declarative ``TransitionTable`` (one ``Row`` per
  role x state x event x guard-case), built per ``Semantics`` variant.
* ``checks``    -- static whole-table checks: completeness, determinism,
  no-silent-drop, state-product consistency, reply-guarantee.
* ``extract``   -- probe-based extraction of the *effective* table from
  each backend (spec engine, general-engine step, C++ engine, and one
  cycle of the per-call kernel K3), diffed against the declared table.
* ``mutate``    -- seeded table mutations for the analyzer self-test.
* ``elision``   -- the exact-replay model of cycle elision.
* ``vmem``      -- the Hopper budget of one CTA of K2/K3.
* ``occupancy`` -- the scheduler's block-segment model.
* ``topology``  -- the interconnect sensitivity study.
* ``ir``        -- the one walker: op census, launches, host syncs,
  graph captures, ptxas.
* ``contracts`` -- declarative pins on what the port's programs do.
* ``lint``      -- AST lint for host syncs, determinism, dtypes and dead
  spec handlers.

CLI: ``python -m hpa2_tpu_torch.analysis {check,lint,equiv,
mutation-test,contracts,vmem,occupancy,elision,topology,table}``.
"""

from hpa2_tpu_torch.analysis.table import (
    Emit, Row, TransitionTable, Unreachable, build_table,
)
from hpa2_tpu_torch.analysis.checks import run_static_checks
from hpa2_tpu_torch.analysis.extract import (
    JaxProber, PallasProber, diff_backend, diff_multi_backend,
)
from hpa2_tpu_torch.analysis.lint import run_lint
from hpa2_tpu_torch.analysis.mutate import run_all_mutations, run_fuzz

__all__ = [
    "Emit",
    "JaxProber",
    "PallasProber",
    "Row",
    "TransitionTable",
    "Unreachable",
    "build_table",
    "diff_backend",
    "diff_multi_backend",
    "run_all_mutations",
    "run_fuzz",
    "run_lint",
    "run_static_checks",
]
