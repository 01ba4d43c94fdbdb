"""Program contracts: declarative pins on what the port's programs do,
the port of ``hpa2_tpu/analysis/contracts.py``.

Every performance claim the port makes -- one launch and one host sync
a streamed run, one captured graph a program, the elided loop's one
extra jump-min reduction, packed planes that stay narrow, a CTA's
shared memory that fits, no register spills in the kernels -- is a
property of what a run *does*, not of its source.  A :class:`Contract`
names one engine x config point, a ``measure`` function that runs it
through :mod:`hpa2_tpu_torch.analysis.ir` (the one canonical walker:
op census, wrapper calls, kernel launches, host syncs, graph captures,
ptxas) and a list of :class:`Rule` bounds over the measured values.

Two rule flavors, as in the JAX package:

* **invariant** (``expect`` is an int): a hard structural law --
  ``calls.stream_run == 1``, ``host_reads == 0``.  Never repinned.
* **pinned** (``expect`` is None): the expected value lives in
  ``hpa2_tpu_torch/analysis/contracts/<name>.json``, digest-keyed
  against the rule spec.  ``--repin`` refreshes the files so a benign
  change lands as a reviewable JSON diff.

A rule with ``card=True`` reads what only the card has (kernel
launches, graph captures, ptxas's registers, the card's shared-memory
figure); measured on the CPU it is skipped, and says so.

On violation the checker emits a structural **drift diff** --
contract, key, expected vs found, where in the op sequence the
offending op fell, and the rule's rationale.

CLI: ``python -m hpa2_tpu_torch.analysis contracts [--check|--repin|
--list] [--engine TAG] [--device cpu]``.  Four sharded points run:
``data-sharded-pallas`` (four data shards, logical on the CPU or one card
named four times), the fast path's node axis at D=4 in the a2a schedule
(``node-sharded-pallas-a2a``) and the general engine's in the a2a and
pairwise schedules (four gloo ranks on the CPU, all three points in one
group; on the card four cards, else skipped), counted through
``parallel/comm.py``'s wrapper.  The JAX package counts a traced
program, the port what runs: a cycle, a window's seed, a later gate.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from hpa2_tpu_torch.analysis import ir

CONTRACT_DIR = os.path.join(os.path.dirname(__file__), "contracts")

_OPS = {
    "==": lambda got, want: got == want,
    "<=": lambda got, want: got <= want,
    ">=": lambda got, want: got >= want,
}

@dataclasses.dataclass(frozen=True)
class Rule:
    """One bound over a measured value.  ``expect is None`` marks a
    pinned rule whose expected value lives in the contract's JSON;
    ``card`` a rule measured on the card only."""

    key: str
    op: str
    expect: Optional[int]
    why: str
    card: bool = False


@dataclasses.dataclass
class Observation:
    """What a measure function saw: the value census plus, for keys
    whose violation has a location, where it fell; ``device`` is the
    device type it ran on."""

    values: Dict[str, int]
    where: Dict[str, str] = dataclasses.field(default_factory=dict)
    device: str = "cpu"


@dataclasses.dataclass(frozen=True)
class Contract:
    name: str
    engine: str  # grouping tag: xla | pallas | serving | sharded
    title: str
    measure: Optional[Callable[[str], Observation]]
    rules: Tuple[Rule, ...]
    needs_devices: int = 1


@dataclasses.dataclass(frozen=True)
class Drift:
    """One line of a structural drift diff."""

    contract: str
    key: str
    op: str
    expected: object
    found: object
    where: str = ""
    why: str = ""

    def render(self) -> str:
        lines = [f"  {self.key}: expected {self.op} {self.expected}, "
                 f"found {self.found}"]
        if self.where:
            lines.append(f"    at: {self.where}")
        if self.why:
            lines.append(f"    why: {self.why}")
        return "\n".join(lines)


@dataclasses.dataclass
class CheckResult:
    contract: str
    engine: str
    status: str  # ok | drift | skip
    drifts: List[Drift] = dataclasses.field(default_factory=list)
    note: str = ""


# -- pin files --------------------------------------------------------


def spec_digest(c: Contract) -> str:
    """Digest of the rule spec: a pin file minted for an older rule set
    is stale and must be regenerated."""
    blob = json.dumps(
        {"contract": c.name, "engine": c.engine,
         "rules": [[r.key, r.op, r.expect, r.card] for r in c.rules]},
        sort_keys=True, separators=(",", ":"),
    )
    return hashlib.sha256(blob.encode()).hexdigest()


def _pin_path(name: str) -> str:
    return os.path.join(CONTRACT_DIR, f"{name}.json")


def load_pins(c: Contract) -> Optional[dict]:
    try:
        with open(_pin_path(c.name)) as fh:
            return json.load(fh)
    except FileNotFoundError:
        return None


def write_pins(c: Contract, obs: Observation) -> str:
    os.makedirs(CONTRACT_DIR, exist_ok=True)
    doc = {
        "contract": c.name,
        "engine": c.engine,
        "digest": spec_digest(c),
        "pins": {r.key: int(obs.values[r.key])
                 for r in c.rules if r.expect is None},
        # informational: everything measured at repin time, so a
        # contract diff reviews as "what moved", not just "what broke"
        "observed": {k: int(v) for k, v in sorted(obs.values.items())},
        "device": obs.device,
    }
    path = _pin_path(c.name)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path


# -- checking ---------------------------------------------------------


def skipped_rules(c: Contract, obs: Observation) -> List[Rule]:
    """The card rules an observation off the card cannot check."""
    return [r for r in c.rules if r.card and obs.device != "cuda"]


def check_contract(c: Contract, obs: Observation) -> List[Drift]:
    drifts: List[Drift] = []
    pins = None
    skipped = skipped_rules(c, obs)
    if any(r.expect is None for r in c.rules):
        doc = load_pins(c)
        if doc is None:
            return [Drift(c.name, "<pin-file>", "==", "present",
                          "missing",
                          why="no pinned expectations on disk — run "
                              "`analysis contracts --repin`")]
        if doc.get("digest") != spec_digest(c):
            return [Drift(c.name, "<pin-file>", "==", spec_digest(c)[:12],
                          str(doc.get("digest"))[:12],
                          why="rule spec changed since the pin file was "
                              "minted — run `analysis contracts --repin`")]
        pins = doc.get("pins", {})
    for r in c.rules:
        if r in skipped:
            continue
        expected = r.expect
        if expected is None:
            if r.key not in pins:
                drifts.append(Drift(c.name, r.key, r.op, "<pinned>",
                                    "missing pin",
                                    why="run `analysis contracts --repin`"))
                continue
            expected = pins[r.key]
        found = obs.values.get(r.key)
        if found is None:
            drifts.append(Drift(c.name, r.key, r.op, expected,
                                "not measured", why=r.why))
        elif not _OPS[r.op](found, expected):
            drifts.append(Drift(c.name, r.key, r.op, expected, found,
                                where=obs.where.get(r.key, ""),
                                why=r.why))
    return drifts


def run_contracts(engine: Optional[str] = None,
                  names: Optional[Sequence[str]] = None,
                  repin: bool = False,
                  out: Callable[[str], None] = print,
                  device="cuda") -> List[CheckResult]:
    """Measure every registered contract point on ``device`` (optionally
    filtered by engine tag or name) and check -- or, with ``repin``,
    refresh -- its pins.  Prints drift diffs through ``out``; returns
    per-contract results."""
    import torch

    from hpa2_tpu_torch.ops.cuda_engine import resolve_device

    dev = resolve_device(device)
    results: List[CheckResult] = []
    for c in registry():
        if engine and c.engine != engine and c.name != engine:
            continue
        if names and c.name not in names:
            continue
        if dev.type == "cuda" and torch.cuda.device_count() < c.needs_devices:
            note = (f"needs {c.needs_devices} cards (NCCL takes one rank "
                    f"a card), have {torch.cuda.device_count()}")
            results.append(CheckResult(c.name, c.engine, "skip",
                                       note=note))
            out(f"SKIP  {c.name} [{c.engine}] — {note}")
            continue
        obs = c.measure(dev.type)
        if repin:
            path = write_pins(c, obs)
            results.append(CheckResult(c.name, c.engine, "ok",
                                       note=f"pinned -> {path}"))
            out(f"PIN   {c.name} [{c.engine}] -> {os.path.relpath(path)}")
            continue
        drifts = check_contract(c, obs)
        skipped = skipped_rules(c, obs)
        note = (f" ({len(skipped)} card rule(s) skipped on {obs.device})"
                if skipped else "")
        if drifts:
            results.append(CheckResult(c.name, c.engine, "drift", drifts,
                                       note=note.strip()))
            out(f"DRIFT {c.name} [{c.engine}] — {c.title}")
            for d in drifts:
                out(d.render())
        else:
            results.append(CheckResult(c.name, c.engine, "ok",
                                       note=note.strip()))
            out(f"OK    {c.name} [{c.engine}]{note}")
    return results


# -- measure functions ------------------------------------------------
#
# Each runs one engine x config point on ``device`` and reduces it to a
# flat {key: int} census through analysis/ir.py.  Module attributes
# (step.build_run, cuda_engine.run_program) are resolved at call time
# so the seeded-mutation harness can intercept them.


def _base_cfg(n=4, **kw):
    from hpa2_tpu_torch.config import Semantics, SystemConfig

    return SystemConfig(num_procs=n, semantics=Semantics().robust(),
                        **kw)


def _paths(where: Dict[str, str], key: str, census: ir.OpCensus,
           ops: Sequence[str]) -> None:
    p = ir.op_paths(census, ops, limit=4)
    if p:
        where[key] = "; ".join(p)


def _steady_census(fn, *args):
    """The op census of ``fn(*args)`` once its constants are built (a
    warm-up call first, as before a graph capture): the same ops on
    the CPU and on the card."""
    fn(*args)
    return ir.op_census(fn, *args)[1]


def _loop_census(cfg, device: str):
    """The op census of one iteration of the general engine's run loop
    (``Run.gated``: the body the card's graph captures)."""
    from hpa2_tpu_torch.ops import state as state_mod
    from hpa2_tpu_torch.ops import step as step_mod
    from hpa2_tpu_torch.utils import trace as trace_mod

    traces = trace_mod.gen_hot_hit_zipf(cfg, 8, seed=0)
    run = step_mod.build_run(cfg)
    st = state_mod.init_state(cfg, traces, device=device)
    return _steady_census(run.gated, st)


def _captures(cfg, device: str) -> int:
    """Graph captures of a whole ``TorchEngine`` run on the card (the
    runner is fresh, so none are cached from before)."""
    from hpa2_tpu_torch.ops import engine as engine_mod
    from hpa2_tpu_torch.ops import step as step_mod
    from hpa2_tpu_torch.utils import trace as trace_mod

    traces = trace_mod.gen_hot_hit_zipf(cfg, 16, seed=0)
    eng = engine_mod.TorchEngine(cfg, traces, device=device)
    eng._run = step_mod.Run(cfg, max_cycles=eng.max_cycles,
                            watchdog_cycles=eng.watchdog_cycles)
    eng.run()
    return ir.graph_census(eng._run)["captures"]


def measure_run_loop(device: str = "cpu", cfg=None) -> Observation:
    """The event-driven loop body adds ONE jump-min reduction over the
    lockstep body, reads nothing back to the host (the card captures it
    as a graph) and sorts nothing; a program captures one graph."""
    import dataclasses as dc

    cfg = cfg or _base_cfg()
    body = _loop_census(cfg, device)
    lockstep = _loop_census(dc.replace(cfg, elide=False), device)
    values = {
        "elided.ops": body.count,
        "elided.jump_min": (ir.count_ops(body, ("min",))
                            - ir.count_ops(lockstep, ("min",))),
        "elided.sort": ir.count_ops(body, ("sort",)),
        "elided.host_reads": ir.count_ops(body, ir.HOST_READ_OPS),
        "elided.extra_ops": body.count - lockstep.count,
        "lockstep.host_reads": ir.count_ops(lockstep, ir.HOST_READ_OPS),
    }
    where: Dict[str, str] = {}
    for key, census, ops in (
            ("elided.sort", body, ("sort",)),
            ("elided.host_reads", body, ir.HOST_READ_OPS),
            ("lockstep.host_reads", lockstep, ir.HOST_READ_OPS)):
        if values[key]:
            _paths(where, key, census, ops)
    if device == "cuda":
        values["captures"] = _captures(cfg, device)
    return Observation(values, where, device)


def measure_interconnect_loop(device: str = "cpu") -> Observation:
    """The interconnect (mesh2d) step under elision: the same one
    jump-min, no host reads, no sort, and its link-priced delivery
    gathers nothing beyond the ideal body."""
    import dataclasses as dc

    from hpa2_tpu_torch.config import InterconnectConfig

    cfg = _base_cfg(interconnect=InterconnectConfig(topology="mesh2d"))
    body = _loop_census(cfg, device)
    lockstep = _loop_census(dc.replace(cfg, elide=False), device)
    ideal = _loop_census(_base_cfg(), device)
    values = {
        "ops": body.count,
        "jump_min": (ir.count_ops(body, ("min",))
                     - ir.count_ops(lockstep, ("min",))),
        "sort": ir.count_ops(body, ("sort",)),
        "host_reads": ir.count_ops(body, ir.HOST_READ_OPS),
        "gather.extra": (ir.count_ops(body, ("gather",))
                         - ir.count_ops(ideal, ("gather",))),
    }
    where: Dict[str, str] = {}
    for key, ops in (("sort", ("sort",)), ("host_reads", ir.HOST_READ_OPS),
                     ("gather.extra", ("gather",))):
        if values[key]:
            _paths(where, key, body, ops)
    if device == "cuda":
        values["captures"] = _captures(cfg, device)
    return Observation(values, where, device)


def measure_cycle_body(device: str = "cpu") -> Observation:
    """ptxas's report on the fast path's kernels (K1 inlined in K2 and
    K3): the most registers a thread and the most spill bytes (stores
    and loads) of any instantiation."""
    from hpa2_tpu_torch.ops import kernels

    values: Dict[str, int] = {}
    where: Dict[str, str] = {}
    if device != "cuda":
        return Observation(values, where, device)
    for kern in kernels.KERNELS:
        kern.build()
        fns = ir.ptxas_census(kern.build_log)
        values[f"{kern.name}.entries"] = len(fns)
        values[f"{kern.name}.registers"] = max(
            (f["registers"] for f in fns), default=0)
        values[f"{kern.name}.spill_bytes"] = max(
            (f["spill_stores"] + f["spill_loads"] for f in fns), default=0)
        spilled = [f["name"] for f in fns
                   if f["spill_stores"] or f["spill_loads"]]
        if spilled:
            where[f"{kern.name}.spill_bytes"] = "; ".join(spilled[:4])
    return Observation(values, where, device)


def measure_stream_dma(device: str = "cpu") -> Observation:
    """A streamed ``run()`` is one call of the streamed kernel (K2) over
    all its windows, no call of the per-call kernel (K3), and one host
    sync: the status read."""
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
    from hpa2_tpu_torch.utils import trace as trace_mod

    cfg = _base_cfg(8, msg_buffer_size=16)
    arrays = trace_mod.gen_uniform_random_arrays(cfg, 8, 16, seed=1)
    eng = CudaEngine(cfg, *arrays, block=8, snapshots=False,
                     trace_window=8, gate=False, device=device)
    with ir.launch_census() as c:
        eng.run()
    values = {k: c[k] for k in ("calls.stream_run", "calls.call_run",
                                "host_syncs")}
    values["windows"] = eng._n_seg
    if device == "cuda":
        values["launches.stream_run"] = c["launches.stream_run"]
        values["launches.call_run"] = c["launches.call_run"]
    return Observation(values, {}, device)


def measure_packed_planes(device: str = "cpu") -> Observation:
    """Dtype rule: the packed run's carried state leaves the run as
    narrow as it entered (u8/u16 planes, no int32 word planes), and the
    state's bytes shrink against the unpacked run's."""
    import torch

    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
    from hpa2_tpu_torch.utils import trace as trace_mod

    cfg = _base_cfg(4, cache_size=4, mem_size=64, msg_buffer_size=4)
    arrays = trace_mod.gen_uniform_random_arrays(cfg, 8, 8, seed=1)
    states = {}
    for packed in (False, True):
        eng = CudaEngine(cfg, *arrays, block=8, snapshots=False,
                         trace_window=8, packed=packed, device=device)
        eng.run()
        states[packed] = eng.state
    narrow = (torch.uint8, torch.uint16)
    size = lambda st: sum(v.numel() * v.element_size()  # noqa: E731
                          for v in st.values())
    return Observation({
        "narrow_planes": sum(v.dtype in narrow for v in states[True].values()),
        "word_planes": sum(f in ("cachew", "dirw") for f in states[True]),
        "state_bytes.packed": size(states[True]),
        "shrinks": int(size(states[True]) < size(states[False])),
    }, {}, device)


def measure_vmem_budget(device: str = "cpu") -> Observation:
    """The Hopper CTA budget (analysis/vmem.py): the main paths' lane
    blocks and the card's largest fit, the model's largest block is
    ``kernels.MAX_LANE_BLOCK``, packing saves device bytes, and on the
    card the model's shared memory is the launch's own."""
    from hpa2_tpu_torch.analysis import vmem
    from hpa2_tpu_torch.ops import kernels

    cfg = _base_cfg(8, msg_buffer_size=16)
    most = kernels.MAX_LANE_BLOCK[kernels.node_bound(cfg)]
    values = {
        f"fits.block{b}": int(vmem.vmem_budget(cfg, b, 32).fits)
        for b in (512, 1024)}
    values["fits.max_block"] = int(vmem.vmem_budget(cfg, most, 32).fits)
    values["max_block.equal"] = int(all(
        vmem.max_fitting_block(_base_cfg(n, msg_buffer_size=16,
                                         max_instr_num=0))
        == kernels.MAX_LANE_BLOCK[b] for n, b in ((8, 8), (21, 21),
                                                  (64, 64))))
    plain = vmem.vmem_budget(cfg, 512, 32)
    packed = vmem.vmem_budget(cfg, 512, 32, packed=True)
    values["packed.saves_bytes"] = int(packed.plane_bytes
                                       < plain.plane_bytes)
    where: Dict[str, str] = {}
    if device == "cuda":
        off = []
        for n in (8, 12, 64):
            c = _base_cfg(n, msg_buffer_size=16, max_instr_num=0)
            top = kernels.MAX_LANE_BLOCK[kernels.node_bound(c)]
            for block in (512, 1024, top):
                for pk in (False, True):
                    model = vmem.vmem_budget(c, block, 32, packed=pk)
                    card = vmem.measured_vmem_bytes(c, block, packed=pk,
                                                    device=device)
                    if card != model.smem_bytes:
                        off.append(f"n={n} block={block} packed={pk}: "
                                   f"model {model.smem_bytes} card {card}")
        values["card.smem_mismatches"] = len(off)
        if off:
            where["card.smem_mismatches"] = "; ".join(off[:4])
    return Observation(values, where, device)


def measure_serving_session(device: str = "cpu") -> Observation:
    """The fast path's serving session: a stage/advance/harvest/barrier/
    check round takes each program's signature once, one K2 call an
    interval and the pinned host syncs, and loads the library once."""
    import numpy as np

    from hpa2_tpu_torch.ops.session import CudaLaneSession

    cfg = _base_cfg()
    r, w = 4, 8
    sess = CudaLaneSession(cfg, r, w, block=4, cycles_per_call=16,
                           max_cycles=64, device=device)
    n = cfg.num_procs
    with ir.launch_census() as c:
        tr, tl = sess.stage(np.zeros((n, w, r), np.int32),
                            np.zeros((n, r), np.int32))
        status = sess.advance(tr, tl)
        sess.harvest(0)
        sess.barrier(np.arange(r), np.zeros(r, bool))
        sess.check(status)
    values = {f"compiles.{k}": v for k, v in sess.compile_counts().items()}
    values.update({k: c[k] for k in ("calls.stream_run", "calls.call_run",
                                     "host_syncs")})
    if device == "cuda":
        values["launches.stream_run"] = c["launches.stream_run"]
    return Observation(values, {}, device)


def measure_recovery_resume(device: str = "cpu") -> Observation:
    """The recovery supervisor's jax -> jax mid-state resume program
    (serving/recovery.py): a ``BatchLaneSession`` driven admit ->
    advance -> take_row -> retire takes each program's signature once,
    captures one chunk graph on the card and reads the host once a chunk
    there, and its chunk body carries the elision jump-min and no host
    read."""
    import torch

    from hpa2_tpu_torch.ops import engine as engine_mod
    from hpa2_tpu_torch.utils import trace as trace_mod

    cfg = _base_cfg()
    sess = engine_mod.BatchLaneSession(cfg, 2, 16, interval=32,
                                       max_cycles=4096, device=device)
    row = sess.fresh_row(trace_mod.gen_uniform_random(cfg, 4, seed=0))
    sess.admit(0, row)
    chunks = 0
    with ir.launch_census() as c:
        for _ in range(64):
            sess.advance()
            chunks += 1
            if sess.quiescent_rows()[0]:
                break
        else:
            raise AssertionError("resume row never quiesced")
    sess.take_row(0)
    sess.retire(0)
    values = {f"compiles.{k}": v for k, v in sess.compile_counts().items()}
    values["chunks"] = chunks
    if device == "cuda":
        values["host_syncs.chunk"] = c["host_syncs"] // chunks
    bound = sess._bound
    zero = torch.zeros((), dtype=torch.int32, device=sess.device)
    body = _steady_census(bound.runner.gated, bound.st, zero)
    values["runner.ops"] = body.count
    values["runner.min"] = ir.count_ops(body, ("min",))
    values["runner.host_reads"] = ir.count_ops(body, ir.HOST_READ_OPS)
    where: Dict[str, str] = {}
    if values["runner.host_reads"]:
        _paths(where, "runner.host_reads", body, ir.HOST_READ_OPS)
    if device == "cuda":
        values["captures"] = ir.graph_census(bound)["captures"]
    return Observation(values, where, device)


# -- registry ---------------------------------------------------------


def measure_data_sharded(device: str = "cpu") -> Observation:
    """A data-sharded streamed ``run()`` over four shards (logical on the
    CPU, one card named four times on the card): one streamed launch a
    shard, no collective, and one host sync, the ORed status read."""
    from hpa2_tpu_torch.parallel.comm import COLLECTIVES
    from hpa2_tpu_torch.parallel.sharding import (
        DataShardedCudaEngine, make_data_mesh,
    )
    from hpa2_tpu_torch.utils import trace as trace_mod

    cfg = _base_cfg(8, msg_buffer_size=16)
    arrays = trace_mod.gen_uniform_random_arrays(cfg, 16, 16, seed=1)
    dev = "cuda:0" if device == "cuda" else "cpu"
    mesh = make_data_mesh(4, devices=[dev] * 4)
    eng = DataShardedCudaEngine(cfg, *arrays, mesh=mesh, block=4,
                                snapshots=False, trace_window=8)
    before = COLLECTIVES.snapshot()
    with ir.launch_census() as c:
        eng.run()
    after = COLLECTIVES.snapshot()
    values = {k: c[k] for k in ("calls.stream_run", "calls.call_run",
                                "host_syncs")}
    values["collectives"] = sum(after.values()) - sum(before.values())
    if device == "cuda":
        values["launches.stream_run"] = c["launches.stream_run"]
    return Observation(values, {}, device)


#: the node-sharded points' observations, by device: the fast path's
#: and both general-engine schedules run in one group of ranks (a rank
#: costs seconds to start)
_NODE_OBS: Dict[str, Dict[str, Observation]] = {}


def _measure_node_points(device: str) -> Dict[str, Observation]:
    if device not in _NODE_OBS:
        import dataclasses as dc

        from hpa2_tpu_torch.parallel.sharding import (
            NodeShardedCudaEngine, NodeShardedEngine, make_mesh,
            run_node_sharded,
        )
        from hpa2_tpu_torch.utils import trace as trace_mod

        def mesh():
            return make_mesh(node_shards=4, data_shards=1, device=device)

        cfg = _base_cfg(8, msg_buffer_size=16, elide=False)
        traces = trace_mod.gen_uniform_random(cfg, 4, seed=1)
        engs = {m: NodeShardedEngine(
            dc.replace(cfg, exchange_mode=m), traces, mesh=mesh())
            for m in ("a2a", "pairwise")}
        pcfg = _base_cfg(8)
        engs["pallas-a2a"] = NodeShardedCudaEngine(
            pcfg, *trace_mod.gen_uniform_random_arrays(pcfg, 4, 12, seed=1),
            mesh=mesh(), cycles_per_call=16)
        run_node_sharded(list(engs.values()))
        obs = {}
        for m, e in engs.items():
            if m == "pallas-a2a":
                st = e.rank_stats[0]
                values = dict(st["census"]["cycle"])
                for part in ("seed", "gate"):
                    values.update({f"{part}.{k}": v for k, v in
                                   st["census"][part].items()})
                values["cycle.total"] = sum(st["census"]["cycle"].values())
                values["host_syncs.extra"] = st["host_syncs"] - st["calls"]
                values["calls"] = st["calls"]
            else:
                values = dict(e.step_collectives)
                values.update({f"loop.{k}": v for k, v in
                               e.rank_stats[0]["loop_collectives"].items()})
            obs[m] = Observation(values, {}, device)
        _NODE_OBS[device] = obs
    return _NODE_OBS[device]


def measure_node_sharded_jax(mode: str, device: str = "cpu") -> Observation:
    """The collectives of one lockstep cycle of the node-sharded general
    engine at D=4 (8 nodes, rank 0's count through ``parallel/comm.py``'s
    wrapper), and of one test of its loop."""
    return _measure_node_points(device)[mode]


def measure_node_sharded_pallas(device: str = "cpu") -> Observation:
    """What the node-sharded fast path issues at D=4 in the a2a schedule
    (8 nodes, 4 systems x 12 instructions, k 16; rank 0's count through
    ``parallel/comm.py``'s wrapper), keyed so that the map to JAX's
    traced census is plain: a cycle (``all_to_all``, ``sum``, ``max``),
    a window's seed with its first gate (``seed.*``), a later k-cycle
    call's gate (``gate.*``), and the host reads beyond one a call."""
    return _measure_node_points(device)["pallas-a2a"]


def registry() -> List[Contract]:
    """Every contract point, in check order.  Literal expectations are
    invariants; ``None`` expectations are pinned in contracts/*.json."""
    elide_why = ("the event-driven loop adds exactly one jump-min "
                 "reduction to the lockstep body")
    read_why = ("the loop body reads nothing back to the host: the card "
                "captures it as a CUDA graph, and a read there would be an "
                "uncounted sync")
    capture_why = "one captured CUDA graph a program and shape"
    coll_why = ("the exchange ships exactly the planned collectives; "
                "gather-the-world delivery is banned")
    compile_why = "one signature per program: nothing is rebuilt"
    launch_why = ("the wrapper's calls are the kernel's launches: each "
                  "call launches once")
    spill_why = ("at 128 registers a thread the cycle spills a few bytes "
                 "in some instantiations; they must not grow (forcing 64 "
                 "registers spilled enough to run 2-3x slower)")
    return [
        Contract(
            "xla-run-loop", "xla",
            "event-driven general-engine loop body (Run.gated)",
            measure_run_loop,
            (
                Rule("elided.jump_min", "==", 1, elide_why),
                Rule("elided.sort", "==", 0, elide_why),
                Rule("elided.host_reads", "==", 0, read_why),
                Rule("lockstep.host_reads", "==", 0, read_why),
                Rule("elided.extra_ops", ">=", 1,
                     "the elided body adds the proposal and the "
                     "fast-forward beside the lockstep step"),
                Rule("elided.ops", "<=", None,
                     "op budget of the elided body (a kernel each on the "
                     "card)"),
                Rule("captures", "==", 1, capture_why, card=True),
            ),
        ),
        Contract(
            "xla-run-interconnect", "xla",
            "interconnect (mesh2d) general-engine step under elision",
            measure_interconnect_loop,
            (
                Rule("jump_min", "==", 1, elide_why),
                Rule("sort", "==", 0, elide_why),
                Rule("host_reads", "==", 0, read_why),
                Rule("gather.extra", "==", 0,
                     "topology delivery is link-priced: it gathers "
                     "nothing beyond the ideal body"),
                Rule("ops", "<=", None,
                     "op budget of the mesh2d body"),
                Rule("captures", "==", 1, capture_why, card=True),
            ),
        ),
        Contract(
            "pallas-cycle-body", "pallas",
            "the cycle (K1) inside K2/K3: registers and spills",
            measure_cycle_body,
            (
                Rule("stream_run.entries", "==", 6,
                     "node bounds 8, 21 and 64, unpacked and packed",
                     card=True),
                Rule("call_run.entries", "==", 6,
                     "node bounds 8, 21 and 64, unpacked and packed",
                     card=True),
                Rule("stream_run.registers", "<=", 128,
                     "512 threads a CTA hold at most 128 registers each",
                     card=True),
                Rule("call_run.registers", "<=", 128,
                     "512 threads a CTA hold at most 128 registers each",
                     card=True),
                # measured on the H100: K2's packed instantiations at
                # bounds 8 and 21 spill 8 B, K3's four 32-52 B; the
                # ceilings hold them there until a redesign removes them
                Rule("stream_run.spill_bytes", "<=", 8, spill_why,
                     card=True),
                Rule("call_run.spill_bytes", "<=", 52, spill_why,
                     card=True),
            ),
        ),
        Contract(
            "pallas-stream-dma", "pallas",
            "a streamed run: one K2 call over every window, one sync",
            measure_stream_dma,
            (
                Rule("calls.stream_run", "==", 1,
                     "the streamed kernel drives the whole run"),
                Rule("calls.call_run", "==", 0,
                     "the streamed run never falls back to per-call "
                     "launches"),
                Rule("windows", ">=", 2,
                     "the point streams several trace windows in that "
                     "one call"),
                Rule("host_syncs", "==", 1,
                     "one host sync a run: the status read"),
                Rule("launches.stream_run", "==", 1, launch_why,
                     card=True),
                Rule("launches.call_run", "==", 0, launch_why,
                     card=True),
            ),
        ),
        Contract(
            "pallas-packed-planes", "pallas",
            "packed-plane dtype rule (u8/u16 never widen)",
            measure_packed_planes,
            (
                Rule("narrow_planes", ">=", 1,
                     "the packed run carries narrow planes at all"),
                Rule("narrow_planes", "==", None,
                     "every narrow plane that enters the run leaves it "
                     "narrow"),
                Rule("word_planes", "==", 0,
                     "no int32 cache/directory word plane survives "
                     "packing"),
                Rule("shrinks", "==", 1,
                     "packing must shrink the state's bytes"),
                Rule("state_bytes.packed", "<=", None,
                     "byte budget of the packed state"),
            ),
        ),
        Contract(
            "pallas-vmem-budget", "pallas",
            "Hopper CTA budget (analysis/vmem.py)",
            measure_vmem_budget,
            (
                Rule("fits.block512", "==", 1,
                     "the main paths' block 512 fits a CTA"),
                Rule("fits.block1024", "==", 1,
                     "block 1024 fits a CTA"),
                Rule("fits.max_block", "==", 1,
                     "the card's largest block (MAX_LANE_BLOCK) fits"),
                Rule("max_block.equal", "==", 1,
                     "the model's largest block is the one the card "
                     "takes (scripts/block_limits.py)"),
                Rule("packed.saves_bytes", "==", 1,
                     "packing must shrink the planes' device bytes"),
                Rule("card.smem_mismatches", "==", 0,
                     "the model's shared memory is the launch's own",
                     card=True),
            ),
        ),
        Contract(
            "pallas-serving-session", "serving",
            "fast-path serving session (stage/advance/harvest/barrier)",
            measure_serving_session,
            (
                Rule("compiles.runner", "==", 1, compile_why),
                Rule("compiles.barrier", "==", 1, compile_why),
                Rule("compiles.take_lane", "==", 1, compile_why),
                Rule("calls.stream_run", "==", 1,
                     "one K2 launch an interval"),
                Rule("calls.call_run", "==", 0,
                     "the streamed session makes no per-call launch"),
                Rule("host_syncs", "==", None,
                     "host syncs of one interval"),
                Rule("compiles.kernel_loads", "==", 1,
                     "the kernel library is built and loaded once",
                     card=True),
                Rule("launches.stream_run", "==", 1, launch_why,
                     card=True),
            ),
        ),
        Contract(
            "serving-recovery-resume", "serving",
            "recovery supervisor's jax -> jax mid-state resume",
            measure_recovery_resume,
            (
                Rule("compiles.runner", "==", 1, compile_why),
                Rule("compiles.admit", "==", 1, compile_why),
                Rule("compiles.take_row", "==", 1, compile_why),
                Rule("compiles.quiescent", "==", 1, compile_why),
                Rule("host_syncs.chunk", "==", 1,
                     "one host read a chunk: quiescence per row and the "
                     "overflow flag", card=True),
                Rule("runner.host_reads", "==", 0, read_why),
                Rule("runner.min", "==", None,
                     "the batched chunk carries the elision jump-min"),
                Rule("runner.ops", "<=", None,
                     "op budget of the resume chunk's gated step"),
                Rule("captures", "==", 1, capture_why, card=True),
            ),
        ),
        Contract(
            "data-sharded-pallas", "sharded",
            "data-sharded streamed run: collective-free, one status read",
            measure_data_sharded,
            (
                Rule("collectives", "==", 0,
                     "each shard's whole run is independent"),
                Rule("calls.stream_run", "==", 4,
                     "one streamed launch a shard (four shards)"),
                Rule("calls.call_run", "==", 0,
                     "a streamed run never calls the per-call kernel"),
                Rule("host_syncs", "==", 1,
                     "the shards' status words OR on one device and are "
                     "read once"),
                Rule("launches.stream_run", "==", 4,
                     "one K2 launch a shard", card=True),
            ),
            needs_devices=1,
        ),
        Contract(
            "node-sharded-pallas-a2a", "sharded",
            "node-sharded fast path collectives (a2a schedule, D=4)",
            measure_node_sharded_pallas,
            (
                Rule("ppermute", "==", 0, coll_why),
                Rule("all_to_all", "==", 2, coll_why),
                Rule("sum", "==", 1,
                     "one stacked SUM a cycle carries every counter and "
                     "the end-of-cycle activity"),
                Rule("max", "==", 1,
                     "one stacked MAX a cycle: the exchange telemetry"),
                Rule("min", "==", 0, "a cycle reduces no minimum"),
                Rule("cycle.total", "==", 4,
                     "nothing else crosses ranks in a cycle: the wrapper "
                     "has no gather, so gather-the-world delivery cannot "
                     "hide here"),
                Rule("seed.sum", "==", 1,
                     "a window's activity is seeded by one SUM outside "
                     "the cycle loop"),
                Rule("seed.max", "==", 1,
                     "the window's first gate: one MAX over every rank"),
                Rule("gate.max", "==", 1,
                     "a later k-cycle call's gate: one MAX over every "
                     "rank"),
                Rule("gate.sum", "==", 0, "a gate sums nothing"),
                Rule("host_syncs.extra", "==", 2,
                     "one host read a k-cycle call, plus the window's "
                     "first gate and the final status"),
                Rule("calls", "==", None,
                     "the k-cycle calls this point takes to quiesce: "
                     "more means the gate missed quiescence"),
            ),
            needs_devices=4,
        ),
    ] + [
        Contract(
            f"node-sharded-jax-{mode}", "sharded",
            f"node-sharded general-engine collectives ({mode}, D=4)",
            (lambda device, mode=mode: measure_node_sharded_jax(mode,
                                                                device)),
            (
                Rule("ppermute", "==", ppermute, coll_why if mode == "a2a"
                     else "the pairwise schedule ships 2*(D-1) serial "
                     "ppermutes at D=4"),
                Rule("all_to_all", "==", a2a, coll_why),
                Rule("sum", "==", 1,
                     "one stacked SUM a cycle replicates every counter"),
                Rule("max", "==", 1,
                     "one MAX a cycle: the exchange's slot high-water "
                     "mark"),
                Rule("min", "==", 0, "the step reduces no minimum"),
                Rule("loop.min", "==", 2,
                     "one loop test: quiescence over the node group and "
                     "the batch-global terms over every rank"),
                Rule("loop.sum", "==", 0, "the loop test sums nothing"),
            ),
            needs_devices=4,
        )
        for mode, ppermute, a2a in (("a2a", 0, 2), ("pairwise", 6, 0))
    ]


# -- seeded mutation (negative-test harness) --------------------------


@contextlib.contextmanager
def seeded_mutation(seed: int):
    """Perturb one op module (monkeypatched, restored on exit) so a
    contract check MUST fail with a drift diff -- the negative test
    that proves the contracts actually bite.

    seed % 2 == 0: force every fast-path run through the per-call
    kernel's host loop (``ops/cuda_engine.run_program`` with
    ``stream=False``) -- pallas-stream-dma drifts on
    ``calls.stream_run``/``calls.call_run``/``host_syncs``.
    seed % 2 == 1: strip elision from the general engine's run builder
    (``ops/step.build_run``) -- xla-run-loop drifts on
    ``elided.jump_min``/``elided.extra_ops``.
    """
    import dataclasses as dc

    from hpa2_tpu_torch.ops import cuda_engine, step

    if seed % 2 == 0:
        mod, attr = cuda_engine, "run_program"
        orig = cuda_engine.run_program

        def mutant(config, state, tr, tr_len, *, stream, **kw):
            return orig(config, state, tr, tr_len, stream=False, **kw)
    else:
        mod, attr = step, "build_run"
        orig = step.build_run

        def mutant(cfg, *a, **kw):
            return orig(dc.replace(cfg, elide=False), *a, **kw)

    setattr(mod, attr, mutant)
    try:
        yield f"{mod.__name__}.{attr}"
    finally:
        setattr(mod, attr, orig)
