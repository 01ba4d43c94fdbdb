"""Protocols-as-data: compile the declarative TransitionTable into the
dense int-indexed planes the kernels execute.

``planes_for(protocol, semantics)`` is the one entry point every
backend shares: it builds the protocol's table, runs the static checks
(completeness / determinism / no-silent-drop / state-product /
reply-guarantee) as a build-time gate, and lowers the rows into a
``ProtocolPlanes`` record of integer state constants and state-set
masks.  ``ops/step.py``'s masked transition logic, the Pallas kernel's
dispatch constants, and the spec engine's handler guards all read these
planes instead of hand-written MESI state constants — a new protocol is
a table edit, zero kernel work.

``directory.py`` holds the directory-format variants (full bitvector,
limited-pointer with overflow-to-broadcast, coarse-vector) applied at
the home's invalidation fan-out composition.
"""

from hpa2_tpu_torch.protocols.compiler import (  # noqa: F401
    ProtocolPlanes,
    compile_planes,
    generated_dispatch,
    planes_for,
    state_in,
)
from hpa2_tpu_torch.protocols.directory import (  # noqa: F401
    DIRECTORY_FORMATS,
    dir_mask_int,
    group_mask_words,
    parse_format,
)
