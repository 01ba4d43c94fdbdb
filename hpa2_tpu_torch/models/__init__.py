"""Protocol data model (message types, cache and directory states,
trace instructions), the names of ``hpa2_tpu.models``."""

from hpa2_tpu_torch.models.protocol import (
    INVALID_ADDR,
    CacheState,
    DirState,
    Instr,
    Message,
    MsgType,
)

__all__ = [
    "CacheState",
    "DirState",
    "MsgType",
    "Message",
    "Instr",
    "INVALID_ADDR",
]
