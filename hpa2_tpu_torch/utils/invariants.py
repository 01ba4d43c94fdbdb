"""Protocol invariant checking at quiescence.

The reference has no consistency checking of any kind (SURVEY.md §5) —
its own debug strings suspect races ("Race condition?",
assignment.c:550) but nothing verifies cache/directory agreement.
These checks hold for the rebuilt fixture-semantics protocol once a
system is quiescent (all traces done, no in-flight messages, nobody
waiting); they do NOT hold mid-flight (the directory commits some
transitions optimistically before acks, assignment.c:230-231).

Checked invariants:

* **single-writer** — at most one cache holds an address in M or E.
* **directory shape** — EM has exactly one sharer bit, S at least one,
  U none.
* **owner recorded** — an M/E line's home directory is EM with exactly
  that node's bit set.
* **EM-reverse** — a quiescent EM entry whose recorded owner does not
  hold the line in M/E, while the owner's cache still carries the
  INVALID placeholder reserved for that address, marks a dropped
  ownership reply (REPLY_WR or an exclusive REPLY_RD): the directory
  committed the transfer but the data never arrived.  The placeholder
  condition matters — an owner that *evicted* its copy while the
  home's UPGRADE_NOTIFY promotion was in flight legally leaves an EM
  entry pointing at a node with no copy and no placeholder.
* **sharer recorded** — an S line's node appears in the home's sharer
  set, and the entry is S or EM (EM occurs transiently-legally when the
  home upgraded the last survivor whose line is now E; a genuinely
  SHARED line under an EM entry owned by someone else is a violation).
* **shared-value coherence** — an S line's value equals home memory
  (S fills come from memory or a FLUSH that also updated memory).

The port's copy of ``hpa2_tpu/utils/invariants.py`` (l.1-159): the
protocol invariants a stall diagnostic reports, kept line for line
because the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.models.protocol import CacheState, DirState, INVALID_ADDR
from hpa2_tpu_torch.utils.dump import NodeDump


def check_invariants(
    dumps: Sequence[NodeDump], config: SystemConfig,
    mid_flight: bool = False,
) -> List[str]:
    """Return a list of human-readable violations (empty = clean).

    ``dumps`` must be the *final quiescent* state of every node, in id
    order (``engine.final_dumps()``), not the per-node completion
    snapshots.

    ``mid_flight=True`` restricts the check to the directory-shape
    invariants, which hold at every cycle boundary (each handler leaves
    every entry it touches in a well-formed shape) — the subset safe
    for per-step debug checking and for watchdog diagnostics of a
    non-quiescent system, where cache/directory agreement is legally
    out of sync while acks are in flight.
    """
    v: List[str] = []
    n = config.num_procs
    if len(dumps) != n:
        return [f"need {n} dumps, got {len(dumps)}"]

    # collect cached copies per address
    holders = {}  # addr -> list[(node, state, value)]
    for d in dumps:
        for idx in range(config.cache_size):
            addr = d.cache_addr[idx]
            state = CacheState(d.cache_state[idx])
            if addr == INVALID_ADDR or state == CacheState.INVALID:
                continue
            holders.setdefault(addr, []).append(
                (d.proc_id, state, d.cache_value[idx])
            )

    if not mid_flight:
        for addr, hs in sorted(holders.items()):
            writers = [h for h in hs if h[1] in (CacheState.MODIFIED,
                                                 CacheState.EXCLUSIVE)]
            if len(writers) > 1:
                v.append(
                    f"single-writer violated at 0x{addr:02X}: {writers}"
                )
            if writers and len(hs) > 1:
                v.append(
                    f"M/E alongside other copies at 0x{addr:02X}: {hs}"
                )

    for home in range(n):
        d = dumps[home]
        for blk in range(config.mem_size):
            addr = config.make_addr(home, blk)
            ds = DirState(d.dir_state[blk])
            sharers = d.dir_sharers[blk]
            nbits = bin(sharers).count("1")
            if ds == DirState.EM and nbits != 1:
                v.append(
                    f"dir EM with {nbits} sharers at 0x{addr:02X} "
                    f"(home {home})"
                )
            elif ds == DirState.S and nbits < 1:
                v.append(f"dir S with no sharers at 0x{addr:02X}")
            elif ds == DirState.U and nbits != 0:
                v.append(f"dir U with sharers at 0x{addr:02X}")
            if mid_flight:
                continue

            hs = holders.get(addr, [])
            # EM-reverse (dropped-ack detector): a quiescent EM entry
            # promises its recorded owner holds the line in M/E.  A
            # lost REPLY_WR/REPLY_RD-exclusive leaves a precise
            # signature — the directory committed the ownership
            # transfer but the data never arrived, so the requester's
            # cache slot is still the INVALID placeholder it reserved
            # for the address.  Requiring the placeholder avoids the
            # legal eviction/UPGRADE_NOTIFY race, where the promoted
            # survivor evicted its copy and holds nothing at all.
            if ds == DirState.EM and nbits == 1:
                owner = sharers.bit_length() - 1
                od = dumps[owner]
                holds = any(
                    node == owner
                    and state in (CacheState.MODIFIED, CacheState.EXCLUSIVE)
                    for node, state, _ in hs
                )
                placeholder = any(
                    od.cache_addr[i] == addr
                    and CacheState(od.cache_state[i]) == CacheState.INVALID
                    for i in range(config.cache_size)
                )
                if not holds and placeholder:
                    v.append(
                        f"dir EM at 0x{addr:02X} records owner node "
                        f"{owner} but its cache still holds the INVALID "
                        "placeholder for the address (dropped ownership "
                        "reply?)"
                    )
            for node, state, value in hs:
                in_set = bool(sharers >> node & 1)
                if state in (CacheState.MODIFIED, CacheState.EXCLUSIVE):
                    if ds != DirState.EM or not in_set:
                        v.append(
                            f"{state.name} line at 0x{addr:02X} on node "
                            f"{node} but dir {ds.name} sharers "
                            f"0b{sharers:b}"
                        )
                elif state == CacheState.SHARED:
                    if ds == DirState.U or not in_set:
                        v.append(
                            f"SHARED line at 0x{addr:02X} on node {node} "
                            f"not in dir ({ds.name} 0b{sharers:b})"
                        )
                    if value != d.memory[blk]:
                        v.append(
                            f"SHARED value {value} != memory "
                            f"{d.memory[blk]} at 0x{addr:02X} node {node}"
                        )
    return v
