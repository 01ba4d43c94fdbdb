"""Static protocol analysis the port needs: the declarative
``TransitionTable`` (``table``) and the whole-table checks (``checks``)
that gate every protocol before it is lowered into planes.  Copies of
``hpa2_tpu/analysis/table.py`` and ``checks.py``; the probers, lint and
mutation tests of ``hpa2_tpu/analysis`` are not ported."""

from hpa2_tpu_torch.analysis.table import (
    Emit, Row, TransitionTable, Unreachable, build_table,
)
from hpa2_tpu_torch.analysis.checks import run_static_checks

__all__ = [
    "Emit",
    "Row",
    "TransitionTable",
    "Unreachable",
    "build_table",
    "run_static_checks",
]
