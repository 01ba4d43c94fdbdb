"""Lane-last state layout of the streamed fast path.

Every plane carries the ensemble (lane) axis last, so neighbouring
systems sit in neighbouring words:

    cachew  [N, C, B]     state | value<<2 | (addr+1)<<10
    dirw    [N, M, B]     mem | dir_state<<8 | sharers<<10
    dirs{w} [N, M, B]     31-bit sharer words (num_procs > 21 only)
    mb{w}   [N, cap, B]   packed message words, head at slot 0
    nsw     [N, B]        mb_count | waiting | pending_write | pc
    ob{w}   [N, 5, B]     deferred outbox words (5 candidate slots)
    tr      [N, T, B]     packed instruction words op | value<<1 | addr<<9
    scalars [10, B], msg_counts [15, B]   counters

The word layouts, the initial state and the dump decoding are the ones
of ``hpa2_tpu/ops/pallas_engine.py`` bit for bit, so state planes move
between the two packages unchanged (``hpa2_tpu_torch.convert``).

Up to 21 nodes the sharer mask sits in the directory word.  Beyond,
it moves to ``SW = ceil(num_procs / 31)`` split ``dirs{w}`` planes and
messages carry it in ``shr{w}`` fields (split mode).  With ``packed``
the two word planes are stored as narrow planes (``cachew`` as
``cvalw`` u8 + ``cmetaw`` u8/u16, ``dirw`` as ``dmemw`` u8 + ``dmetaw``
u8/u16) that the cycle widens to the words at entry and narrows at
exit.
"""

from __future__ import annotations

import functools
import warnings
from typing import List

import numpy as np
import torch

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.models.protocol import CacheState, DirState, MsgType
from hpa2_tpu_torch.utils.dump import NodeDump


class StallError(RuntimeError):
    """The run stopped making progress (protocol livelock, or a cycle
    budget too small for the workload)."""


# MESI cache and directory state indices
_M = int(CacheState.MODIFIED)
_E = int(CacheState.EXCLUSIVE)
_S = int(CacheState.SHARED)
_I = int(CacheState.INVALID)
_EM = int(DirState.EM)
_DS = int(DirState.S)
_DU = int(DirState.U)

_NO_MSG = -1

# candidate slots, in delivery order: phase-A point sends (2), the INV
# fan-out, phase-B point sends (2)
_NSLOTS = 5

# scalar counter rows (scalars[row, :])
(_SC_CYCLE, _SC_INSTR, _SC_MSGS, _SC_OVERFLOW, _SC_RH, _SC_RM,
 _SC_WH, _SC_WM, _SC_EV, _SC_INV) = range(10)
_NSCALAR = 10

_NTYPES = len(MsgType)

# trace word: op(1) | value(8) | addr(rest)
_TR_ADDR_SHIFT = 9

# packed directory word: mem(8) | dir_state(2) | sharers(<=21)
_DW_STATE_SHIFT = 8
_DW_SH_SHIFT = 10
# packed cache word: state(2) | value(8) | addr+1(<=21)
_CW_VAL_SHIFT = 2
_CW_ADDR_SHIFT = 10
_ADDR_MASK = (1 << 21) - 1

# quiescence gate granularity (cycles)
_GATE = 8

# widest system whose sharer mask fits the directory word beside
# mem(8) and state(2); wider systems use split sharer planes
MAX_UNSPLIT_PROCS = 21
# bits per sharer word in split mode (sign-safe int32 shifts)
_SPLIT_BPW = 31

_PACKED_CACHE = ("cvalw", "cmetaw")
_PACKED_DIR = ("dmemw", "dmetaw")

#: the tensor type of each plane type (int32 words, u8/u16 packed planes)
TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                np.dtype(np.uint8): torch.uint8,
                np.dtype(np.uint16): torch.uint16}


def _bits_for(n_values: int) -> int:
    """Bits to store 0 .. n_values-1."""
    b = 1
    while (1 << b) < n_values:
        b += 1
    return b


def choose_block(lanes: int, requested: int) -> int:
    """Largest divisor of ``lanes`` not exceeding ``requested`` (the
    blocks tile the lane axis exactly); warns when that is under half
    the capped request."""
    cap = max(1, min(requested, lanes))
    best = 1
    for d in range(1, int(lanes ** 0.5) + 1):
        if lanes % d:
            continue
        for c in (d, lanes // d):
            if best < c <= cap:
                best = c
    if best * 2 < cap:
        warnings.warn(
            f"ensemble of {lanes} lanes has no block divisor near the "
            f"requested {requested}: using block={best} (< half the "
            "request), which costs lane parallelism; pad the batch to "
            "a composite size (e.g. a multiple of 256)",
            RuntimeWarning,
            stacklevel=3,
        )
    return best


def _split_mode(config: SystemConfig) -> bool:
    """Sharers live in split ``dirs{w}`` planes and ``shr{w}`` message
    fields (the widened-bitVector systems)."""
    return config.num_procs > MAX_UNSPLIT_PROCS


def _sharer_words(config: SystemConfig) -> int:
    """SW: 31-bit words of a sharer set (1 when unsplit)."""
    if not _split_mode(config):
        return 1
    return -(-config.num_procs // _SPLIT_BPW)


def _split_sw(config: SystemConfig) -> int:
    """Number of ``dirs{w}`` planes (0 when unsplit)."""
    return _sharer_words(config) if _split_mode(config) else 0


def _check_geometry(config: SystemConfig) -> None:
    """The refusal gates of the fast path."""
    if config.num_addresses >= (1 << 21):
        raise ValueError("the fast path supports addresses < 2^21")
    if config.protocol != "mesi" or config.directory_format != "full":
        raise ValueError(
            "the fast path is specialized to the MESI/full-bitvector "
            "build; use the general engine (ops/engine.py) for "
            f"protocol={config.protocol!r} "
            f"directory_format={config.directory_format!r}"
        )


def _check_semantics(config: SystemConfig) -> None:
    if config.semantics.overloaded_evict_shared_notify:
        raise ValueError("the fast path implements fixture semantics only")
    if config.messages_per_cycle != 1:
        raise ValueError(
            "the fast path drains one message per node per cycle; "
            "messages_per_cycle > 1 runs on the spec engine"
        )


@functools.lru_cache(maxsize=64)
def _mb_layout(config: SystemConfig):
    """Field -> (word, offset, width) packing of one message, plus the
    word count W.  Words hold at most 31 bits.  A trailing ``recv``
    field (stored recv+1, meaningful only in deferred outbox words)
    is added when it fits the last word; otherwise a separate
    ``ob_recv`` plane holds the receivers.  In split mode ``aux``
    narrows to its 9-bit value|excl role and each sharer word rides a
    31-bit ``shr{w}`` field on a message word of its own."""
    _check_geometry(config)
    n = config.num_procs
    split = _split_mode(config)
    fields = [
        ("type", 4),
        ("sender", _bits_for(n)),
        ("second", _bits_for(n + 1)),   # stored as second+1
        ("addr", _bits_for(config.num_addresses)),
        ("aux", 9 if split else max(n, 9)),  # value | excl<<8, or sharers
    ]
    if split:
        fields += [(f"shr{w}", _SPLIT_BPW)
                   for w in range(_sharer_words(config))]
    layout = {}
    word, off = 0, 0
    for name, wd in fields:
        if off + wd > 31:
            word, off = word + 1, 0
        layout[name] = (word, off, wd)
        off += wd
    recv_wd = _bits_for(n + 1)          # stored as recv+1
    if off + recv_wd <= 31:
        layout["recv"] = (word, off, recv_wd)
    return layout, word + 1


def _scalar_layout(config: SystemConfig, t_dim: int):
    """Offsets of the packed per-node row ``nsw``:
    mb_count | waiting | pending_write | pc.  Raises when the fields
    cannot share 31 bits (pass a smaller trace_window)."""
    count_bits = _bits_for(config.msg_buffer_size + 1)
    pc_bits = _bits_for(t_dim + 1)
    off_wait = count_bits
    off_pw = count_bits + 1
    off_pc = count_bits + 9
    total = off_pc + pc_bits
    if total > 31:
        raise ValueError(
            f"packed scalar row needs {total} bits (msg_buffer_size="
            f"{config.msg_buffer_size}, trace window {t_dim}); use a "
            "smaller trace_window"
        )
    return {
        "count_mask": (1 << count_bits) - 1,
        "off_wait": off_wait,
        "off_pw": off_pw,
        "pw_mask": 0xFF,
        "off_pc": off_pc,
        "pc_mask": (1 << pc_bits) - 1,
    }


def _state_fields(W: int, snapshots: bool, recv_packed: bool,
                  split_sw: int = 0, packed: bool = False):
    """Carried state names, in kernel argument order.  ``split_sw`` > 0
    adds the ``dirs{w}`` planes (and snapshot twins); ``packed`` swaps
    the cachew/dirw word planes (and twins) for their narrow planes."""
    words = list(_PACKED_CACHE + _PACKED_DIR) if packed else ["cachew", "dirw"]
    f = list(words)
    f += [f"dirs{w}" for w in range(split_sw)]
    f += [f"mb{w}" for w in range(W)]
    f += ["nsw"]
    f += [f"ob{w}" for w in range(W)]
    f += [] if recv_packed else ["ob_recv"]
    if snapshots:
        f += ["snap_taken"] + [f"snap_{p}" for p in words]
        f += [f"snap_dirs{w}" for w in range(split_sw)]
    f += ["scalars", "msg_counts"]
    return tuple(f)


def fields_of(config: SystemConfig, snapshots: bool, packed: bool = False):
    """:func:`_state_fields` of ``config``."""
    layout, W = _mb_layout(config)
    return _state_fields(W, snapshots, "recv" in layout, _split_sw(config),
                         packed)


def state_shapes(config: SystemConfig, snapshots: bool,
                 packed: bool = False):
    """Per-field carried-state shapes without the trailing lane axis."""
    n, c, m = config.num_procs, config.cache_size, config.mem_size
    cap = config.msg_buffer_size
    layout, W = _mb_layout(config)
    if packed:
        shapes = {"cvalw": (n, c), "cmetaw": (n, c),
                  "dmemw": (n, m), "dmetaw": (n, m)}
    else:
        shapes = {"cachew": (n, c), "dirw": (n, m)}
    shapes.update({
        "nsw": (n,),
        "scalars": (_NSCALAR,), "msg_counts": (_NTYPES,),
    })
    if "recv" not in layout:
        shapes["ob_recv"] = (n, _NSLOTS)
    if snapshots:
        shapes["snap_taken"] = (n,)
        shapes.update({f"snap_{f}": shapes[f] for f in (
            _PACKED_CACHE + _PACKED_DIR if packed else ("cachew", "dirw"))})
    for w in range(_split_sw(config)):
        shapes[f"dirs{w}"] = (n, m)
        if snapshots:
            shapes[f"snap_dirs{w}"] = (n, m)
    for w in range(W):
        shapes[f"mb{w}"] = (n, cap)
        shapes[f"ob{w}"] = (n, _NSLOTS)
    return shapes


def _meta_dtype(bits: int):
    """Narrowest unsigned dtype holding ``bits`` bits, or None when
    only int32 would fit."""
    if bits <= 8:
        return np.dtype(np.uint8)
    if bits <= 16:
        return np.dtype(np.uint16)
    return None


def packed_plane_dtypes(config: SystemConfig):
    """Dtypes of the four packed planes; raises when a meta field
    cannot narrow below int32 (packing would only add planes)."""
    cmeta_bits = 2 + _bits_for(config.num_addresses + 1)
    # in split mode dmetaw holds only the 2-bit directory state
    dmeta_bits = 2 + (0 if _split_mode(config) else config.num_procs)
    cd, dd = _meta_dtype(cmeta_bits), _meta_dtype(dmeta_bits)
    if cd is None or dd is None:
        raise ValueError(
            f"packed planes need cache meta <= 16 bits (got "
            f"{cmeta_bits}: num_addresses={config.num_addresses}) and "
            f"dir meta <= 16 bits (got {dmeta_bits}: num_procs="
            f"{config.num_procs}); run this geometry with packed=False"
        )
    return {
        "cvalw": np.dtype(np.uint8), "cmetaw": cd,
        "dmemw": np.dtype(np.uint8), "dmetaw": dd,
    }


def state_dtypes(config: SystemConfig, snapshots: bool,
                 packed: bool = False):
    """int32 everywhere except the packed planes and their twins."""
    dtypes = {f: np.dtype(np.int32)
              for f in state_shapes(config, snapshots, packed)}
    if packed:
        for f, dt in packed_plane_dtypes(config).items():
            dtypes[f] = dt
            if snapshots:
                dtypes[f"snap_{f}"] = dt
    return dtypes


def field(layout, words, name):
    """Decode message field ``name`` from a list of word tensors."""
    w, off, wd = layout[name]
    x = words[w]
    if off:
        x = x >> off
    return x & ((1 << wd) - 1)


def deferred_valid(config: SystemConfig, s) -> torch.Tensor:
    """[N, 5, ...] int32 validity of the deferred outbox slots, derived
    from the outbox words: point slots (0, 1, 3, 4) are valid iff their
    receiver is present, the INV slot (2) iff its remaining mask (the
    OR of the ``shr{w}`` fields in split mode) is nonzero."""
    layout, W = _mb_layout(config)
    obw = [s[f"ob{w}"] for w in range(W)]
    point = (
        field(layout, obw, "recv") if "recv" in layout
        else s["ob_recv"] + 1
    )
    if _split_mode(config):
        inv = field(layout, obw, "shr0")
        for w in range(1, _sharer_words(config)):
            inv = inv | field(layout, obw, f"shr{w}")
    else:
        inv = field(layout, obw, "aux")
    sel = torch.cat([point[:, :2], inv[:, 2:3], point[:, 3:]], dim=1)
    return (sel != 0).to(torch.int32)


def _pack_traces(config: SystemConfig, tr_op, tr_addr, tr_val, tr_len):
    """[B, N, T] op/addr/val arrays -> packed [N, T, B] int32 words.
    Padding beyond tr_len is zero (never fetched)."""
    t = tr_op.shape[2]
    valid = np.arange(t)[None, None, :] < tr_len[:, :, None]
    opx = tr_op.astype(np.int64)
    valx = tr_val.astype(np.int64)
    addrx = tr_addr.astype(np.int64)
    if valid.any():
        if not ((opx[valid] >= 0) & (opx[valid] <= 1)).all():
            raise ValueError("trace ops must be 0 (RD) or 1 (WR)")
        if not ((valx[valid] >= 0) & (valx[valid] < 256)).all():
            raise ValueError("trace values must be bytes (mod 256)")
        if not (
            (addrx[valid] >= 0) & (addrx[valid] < config.num_addresses)
        ).all():
            raise ValueError("trace addresses out of range")
    tr = np.where(
        valid, opx | (valx << 1) | (addrx << _TR_ADDR_SHIFT), 0
    ).astype(np.int32)
    return np.ascontiguousarray(np.moveaxis(tr, 0, -1))


def _split_word_planes_np(config: SystemConfig, cachew, dirw):
    """Numpy split of cachew/dirw word planes into the four packed
    planes (the inverse of :func:`_join_word_planes_np`)."""
    pdt = packed_plane_dtypes(config)
    cw = cachew.astype(np.int64)
    dw = dirw.astype(np.int64)
    return {
        "cvalw": ((cw >> _CW_VAL_SHIFT) & 0xFF).astype(np.uint8),
        "cmetaw": ((cw & 3) | ((cw >> _CW_ADDR_SHIFT) << 2)).astype(
            pdt["cmetaw"]),
        "dmemw": (dw & 0xFF).astype(np.uint8),
        "dmetaw": (((dw >> _DW_STATE_SHIFT) & 3)
                   | ((dw >> _DW_SH_SHIFT) << 2)).astype(pdt["dmetaw"]),
    }


def _join_word_planes_np(cvalw, cmetaw, dmemw, dmetaw):
    """Numpy join of the four packed planes into int32 cachew/dirw
    words (readback and dump decoding)."""
    cm = cmetaw.astype(np.int64)
    dmt = dmetaw.astype(np.int64)
    cachew = ((cm & 3) | (cvalw.astype(np.int64) << _CW_VAL_SHIFT)
              | ((cm >> 2) << _CW_ADDR_SHIFT)).astype(np.int32)
    dirw = (dmemw.astype(np.int64) | ((dmt & 3) << _DW_STATE_SHIFT)
            | ((dmt >> 2) << _DW_SH_SHIFT)).astype(np.int32)
    return cachew, dirw


def decode_dumps(config: SystemConfig, cachew, dirw, sys_idx: int,
                 dirs=None) -> List[NodeDump]:
    """One system's column of the cache/directory word planes (numpy)
    as per-node dump records; ``dirs`` holds the split sharer-word
    planes of a split-mode system."""
    n = config.num_procs
    sh_mask = (1 << min(n, _SPLIT_BPW)) - 1

    def sharers_of(i):
        if dirs is None:
            return [int(x) for x in (dirw[i, :, sys_idx] >> _DW_SH_SHIFT)
                    & sh_mask]
        return [
            sum(int(dirs[w][i, j, sys_idx]) << (w * _SPLIT_BPW)
                for w in range(len(dirs)))
            for j in range(config.mem_size)
        ]

    return [
        NodeDump(
            proc_id=i,
            memory=[int(x) for x in dirw[i, :, sys_idx] & 0xFF],
            dir_state=[
                int(x)
                for x in (dirw[i, :, sys_idx] >> _DW_STATE_SHIFT) & 3
            ],
            dir_sharers=sharers_of(i),
            cache_addr=[
                int(x) - 1
                for x in (cachew[i, :, sys_idx] >> _CW_ADDR_SHIFT)
                & _ADDR_MASK
            ],
            cache_value=[
                int(x)
                for x in (cachew[i, :, sys_idx] >> _CW_VAL_SHIFT) & 0xFF
            ],
            cache_state=[int(x) for x in cachew[i, :, sys_idx] & 3],
        )
        for i in range(n)
    ]


def _init_state(config: SystemConfig, b: int, snapshots: bool = True,
                packed: bool = False):
    """Initial state planes (numpy) for ``b`` systems: memory holds
    (20*node + block) % 256, every directory entry is U, every cache
    line is invalid."""
    n, c, m = config.num_procs, config.cache_size, config.mem_size
    cap = config.msg_buffer_size
    layout, W = _mb_layout(config)

    mem0 = np.array(
        [[(20 * i + j) % 256 for j in range(m)] for i in range(n)],
        dtype=np.int32,
    )
    dirw0 = np.broadcast_to(
        (mem0 | (_DU << _DW_STATE_SHIFT))[:, :, None], (n, m, b)
    ).copy()
    # invalid line: state I, value 0, addr -1 (stored +1 = 0)
    cachew0 = np.full((n, c, b), _I, np.int32)

    def words(cw, dw, prefix=""):
        if packed:
            return {f"{prefix}{f}": v for f, v in
                    _split_word_planes_np(config, cw, dw).items()}
        return {f"{prefix}cachew": cw, f"{prefix}dirw": dw}

    z2 = np.zeros((n, b), dtype=np.int32)
    state = words(cachew0.copy(), dirw0)
    state.update({
        "nsw": z2.copy(),
        "scalars": np.zeros((_NSCALAR, b), np.int32),
        "msg_counts": np.zeros((_NTYPES, b), np.int32),
    })
    for w in range(_split_sw(config)):
        state[f"dirs{w}"] = np.zeros((n, m, b), np.int32)
    for w in range(W):
        state[f"mb{w}"] = np.zeros((n, cap, b), np.int32)
        state[f"ob{w}"] = np.zeros((n, _NSLOTS, b), np.int32)
    if "recv" not in layout:
        # -1 = empty (deferred_valid's point-slot sentinel)
        state["ob_recv"] = np.full((n, _NSLOTS, b), -1, np.int32)
    if snapshots:
        state["snap_taken"] = z2.copy()
        state.update(words(cachew0.copy(), dirw0.copy(), "snap_"))
        for w in range(_split_sw(config)):
            state[f"snap_dirs{w}"] = np.zeros((n, m, b), np.int32)
    return state
