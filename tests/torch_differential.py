"""The random differential of ``tests/test_random_differential.py`` over
the port's engines, shared by ``test_torch_random_differential.py`` and
``test_torch_adversarial_differential.py``.

Each system runs on the JAX package's spec engine and ``JaxEngine``
(the references, which must agree with each other), then on the port:
its spec engine and ``BatchTorchEngine`` always, ``native.py`` where the
JAX sweep runs the native engine, and ``CudaEngine(device="cpu")``
streamed and per-call where it runs ``PallasEngine``.  Every port engine
must give each system the references' final dumps, instruction and
message counts, and must stall on exactly the systems the references
stall on (a bounded mailbox can deadlock: cyclically blocked senders)."""

import dataclasses

import pytest

from hpa2_tpu.config import Semantics as JSemantics
from hpa2_tpu.config import SystemConfig as JSystemConfig
from hpa2_tpu.models.protocol import Instr as JInstr
from hpa2_tpu.models.spec_engine import SpecEngine as JSpecEngine
from hpa2_tpu.models.spec_engine import StallError as JStallError
from hpa2_tpu.ops.engine import JaxEngine
from hpa2_tpu_torch import native
from hpa2_tpu_torch.config import Semantics, SystemConfig
from hpa2_tpu_torch.models.protocol import Instr
from hpa2_tpu_torch.models.spec_engine import SpecEngine, StallError
from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
from hpa2_tpu_torch.ops.engine import BatchTorchEngine
from hpa2_tpu_torch.ops.layout import _scalar_layout
from hpa2_tpu_torch.ops.step import quiescent
from hpa2_tpu_torch.ops.stream_run import active_count
from hpa2_tpu_torch.utils.dump import format_processor_state

#: cycles the spec engines and the general engines may run (the JAX
#: sweep's); the fast path's plain versions run every lane each cycle,
#: so their budget is shorter: a live system here quiesces in a few
#: hundred cycles, and a lane the references do not stall must not
#: stall here either
MAX_CYCLES = 50_000
FAST_PATH_CYCLES = 4_096
#: cycles without a retired instruction or a drained mailbox after which
#: ``BatchTorchEngine`` stops on its deadlocked systems (a live system
#: drains a mailbox or retires an instruction every cycle or two)
WATCHDOG = 64


def geometry(n, c, m, cap):
    """One robust configuration in both packages."""
    return (JSystemConfig(num_procs=n, cache_size=c, mem_size=m,
                          msg_buffer_size=cap,
                          semantics=JSemantics().robust()),
            SystemConfig(num_procs=n, cache_size=c, mem_size=m,
                         msg_buffer_size=cap,
                         semantics=Semantics().robust()))


# (num_procs, cache_size, mem_size, msg_buffer_size), batch,
# instructions a core, engines beyond the spec and general engines:
# tests/test_random_differential.py l.33-62 ...
GEOMETRIES = [
    ((4, 4, 16, 256), 30, 16, ("native", "pallas")),
    ((8, 2, 8, 4), 38, 16, ("native",)),    # tiny capacity: deadlocks
    ((8, 4, 16, 16), 30, 16, ("native", "pallas")),  # the bench geometry
    ((3, 3, 5, 8), 40, 20, ("native", "pallas")),    # odd sizes
    ((12, 4, 16, 32), 26, 12, ("native",)),
    ((21, 2, 8, 16), 12, 10, ("native", "pallas")),  # the unsplit limit
    ((40, 4, 8, 32), 12, 10, ("native",)),  # two sharer words
    ((33, 4, 8, 32), 12, 10, ("pallas",)),  # split planes
]
# ... l.209-224 (eviction ping-pong traffic) ...
ADVERSARIAL_GEOMETRIES = [
    ((4, 4, 16, 8), 20, 24, ("native", "pallas")),
    ((8, 2, 8, 4), 20, 16, ("native",)),    # deadlock reachable
    ((8, 4, 8, 6), 16, 20, ("native", "pallas")),
    ((12, 4, 16, 8), 10, 14, ("native",)),
]
# ... and l.245-258 (the slow tier)
SLOW_GEOMETRIES = [
    ((8, 4, 16, 16), 32, 48, ("native", "pallas")),
    ((16, 4, 16, 32), 24, 24, ("native", "pallas")),
    ((33, 4, 8, 32), 10, 16, ("native", "pallas")),
    ((48, 2, 8, 16), 6, 10, ("native", "pallas")),
]


def traces_of(instr, arrays, b, n):
    op, addr, val, _ = arrays
    return [
        [instr("W", int(a), int(v)) if o == 1 else instr("R", int(a))
         for o, a, v in zip(op[b, i], addr[b, i], val[b, i])]
        for i in range(n)
    ]


def dicts(dumps):
    return [d.__dict__ for d in dumps]


def write_traces(traces, d):
    d.mkdir(parents=True, exist_ok=True)
    for i, tr in enumerate(traces):
        (d / f"core_{i}.txt").write_text("".join(
            f"RD 0x{x.address:02X}\n" if x.op == "R"
            else f"WR 0x{x.address:02X} {x.value}\n" for x in tr))


def references(jcfg, arrays, batch):
    """Per system: None when it stalls on the JAX spec engine (and then
    on ``JaxEngine`` too), else its final dumps, instructions and
    messages, on which the two agree."""
    n = jcfg.num_procs
    want = []
    for b in range(batch):
        traces = traces_of(JInstr, arrays, b, n)
        spec = JSpecEngine(jcfg, traces)
        jx = JaxEngine(jcfg, traces, max_cycles=MAX_CYCLES)
        try:
            spec.run(max_cycles=MAX_CYCLES)
        except JStallError:
            with pytest.raises(JStallError):
                jx.run()
            want.append(None)
            continue
        jx.run()
        dumps = dicts(jx.final_dumps())
        assert dicts(spec.final_dumps()) == dumps, f"JAX spec vs xla b={b}"
        assert (spec.instructions, spec.messages) == (
            jx.instructions, jx.messages), f"JAX spec vs xla b={b}"
        want.append((dumps, spec.instructions, spec.messages))
    return want


def check_fast_path(tcfg, arrays, want, stream):
    """``CudaEngine`` on the CPU, every system its own lane block: the
    lanes the references stall on, and only those, keep work at the
    budget; every other lane's final dumps and counters agree."""
    batch = len(want)
    eng = CudaEngine(tcfg, *arrays, block=1, cycles_per_call=64,
                     stream=stream, device="cpu")
    stalled_any = any(w is None for w in want)
    try:
        eng.run(max_cycles=FAST_PATH_CYCLES)
        assert not stalled_any, "the fast path quiesced where a "\
            "reference stalled"
    except StallError:
        assert stalled_any, "the fast path stalled where no reference did"
    slsc = _scalar_layout(tcfg, eng._window)
    tl = eng._tr_len_full.clamp(0, eng._window)
    busy = (active_count(tcfg, eng.state, tl, slsc) != 0).numpy()
    assert busy.tolist() == [w is None for w in want], stream
    sc = eng.state["scalars"].numpy()
    for b in range(batch):
        if want[b] is None:
            continue
        dumps, instrs, msgs = want[b]
        assert dicts(eng.system_final_dumps(b)) == dumps, (stream, b)
        assert (int(sc[1, b]), int(sc[2, b])) == (instrs, msgs), (stream, b)


def sweep(jcfg, tcfg, batch, extra, arrays, tmp_path, allow_stall):
    """The JAX references, then each port engine against them."""
    n = tcfg.num_procs
    want = references(jcfg, arrays, batch)
    stalled = [w is None for w in want]
    assert allow_stall or not any(stalled)

    # the port's spec engine, system by system
    for b in range(batch):
        spec = SpecEngine(tcfg, traces_of(Instr, arrays, b, n))
        try:
            spec.run(max_cycles=MAX_CYCLES)
        except StallError:
            assert stalled[b], f"port spec stalled b={b}"
            continue
        assert not stalled[b], f"port spec quiesced b={b}"
        assert (dicts(spec.final_dumps()), spec.instructions,
                spec.messages) == want[b], f"port spec b={b}"

    # the port's general engine, the whole batch at once
    gen = BatchTorchEngine(
        tcfg, [traces_of(Instr, arrays, b, n) for b in range(batch)],
        max_cycles=MAX_CYCLES, watchdog_cycles=WATCHDOG, device="cpu")
    try:
        gen.run()
        assert not any(stalled)
    except StallError:
        assert any(stalled)
    assert (~quiescent(gen.state)).tolist() == stalled
    for b in range(batch):
        if not stalled[b]:
            assert dicts(gen.system_final_dumps(b)) == want[b][0], b
            assert (int(gen.state.n_instr[b]),
                    int(gen.state.n_msgs[b])) == want[b][1:], b

    if "pallas" in extra:
        for stream in (True, False):
            check_fast_path(tcfg, arrays, want, stream)

    if "native" in extra:
        # the native engine reads its traces from files, at most
        # max_instr_num (the reference's 32) a core; the traces here are
        # handed whole to every other engine, so it reads them uncapped
        # (the JAX sweep's slow tier keeps the cap and fails its first
        # geometry there: 48 instructions a core, 32 read)
        ncfg = dataclasses.replace(tcfg, max_instr_num=0)
        for b in range(batch):
            traces = traces_of(Instr, arrays, b, n)
            tr_dir, out = tmp_path / f"tr_{b}", tmp_path / f"out_{b}"
            write_traces(traces, tr_dir)
            out.mkdir(parents=True, exist_ok=True)
            kw = dict(mode="lockstep", final_dump=True,
                      max_cycles=MAX_CYCLES)
            if stalled[b]:
                with pytest.raises(native.NativeError, match="livelock"):
                    native.run_trace_dir(ncfg, str(tr_dir), str(out), **kw)
                continue
            res = native.run_trace_dir(ncfg, str(tr_dir), str(out), **kw)
            dumps, instrs, msgs = want[b]
            assert (int(res.instructions), int(res.messages)) == (
                instrs, msgs), f"native b={b}"
            for i in range(n):
                got = (out / f"core_{i}_output.txt").read_text()
                assert got == format_processor_state(
                    gen.system_final_dumps(b)[i], tcfg), (b, i)
    return stalled
