"""The fast path's node axis (``hpa2_tpu_torch.parallel``:
``NodeShardedCudaEngine``, K1's node-sharded variant in
``ops/cycle.py:build_cycle(axis_name=)``) in 2 and 8 gloo ranks on the
CPU, against the JAX package (``tests/test_node_sharded_pallas.py``):
every plane, the eight transient rows, cycle, instructions, messages,
``stats()`` and every system's dumps, held against interpreted
``PallasEngine`` (8 nodes x 4 systems x 12 instructions, 22 x 2 x 8)
and against JAX ``NodeShardedPallasEngine`` on the same mesh (the
transient rows and the ``exchange_*`` stats).  The runs of one rank
count share one spawned group; the JAX references are built once a
module."""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from hpa2_tpu.models.spec_engine import StallError as JStallError
from hpa2_tpu.ops.pallas_engine import PallasEngine
from hpa2_tpu.ops.schedule import Schedule as JSchedule
from hpa2_tpu.parallel.sharding import NodeShardedPallasEngine
from hpa2_tpu.utils.trace import gen_uniform_random_arrays
from hpa2_tpu_torch.models.spec_engine import StallError
from hpa2_tpu_torch.ops.cycle import TRANSIENTS
from hpa2_tpu_torch.ops.schedule import Schedule
from hpa2_tpu_torch.parallel import NodeShardedCudaEngine, make_mesh
from hpa2_tpu_torch.parallel.sharding import run_node_sharded
from torch_pairs import IGNORE_PLTPU_ANY, config_pair, dicts
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)

KW = dict(cycles_per_call=16)


@functools.lru_cache(maxsize=None)
def _cfgs(n=8, mode="a2a"):
    jcfg, tcfg = config_pair(True, num_procs=n)
    return (dataclasses.replace(jcfg, exchange_mode=mode),
            dataclasses.replace(tcfg, exchange_mode=mode))


@functools.lru_cache(maxsize=None)
def _arrays(n=8, b=4, t=12, seed=1):
    return gen_uniform_random_arrays(_cfgs(n)[0], b, t, seed=seed)


@functools.lru_cache(maxsize=None)
def _interpreted(n=8, b=4, t=12, seed=1, snapshots=True):
    """The one-chip reference: the Pallas kernel in interpret mode."""
    return PallasEngine(_cfgs(n)[0], *_arrays(n, b, t, seed),
                        interpret=True, block=max(b // 2, 1),
                        snapshots=snapshots).run()


@functools.lru_cache(maxsize=None)
def _jax_sharded(node, data=1, n=8, b=4, t=12, snapshots=True, slots=None):
    """JAX ``NodeShardedPallasEngine`` on the same mesh (XLA on the
    virtual CPU devices): (engine, its StallError message or None)."""
    eng = NodeShardedPallasEngine(
        _cfgs(n)[0], *_arrays(n, b, t), node_shards=node, data_shards=data,
        snapshots=snapshots, exchange_slots=slots, **KW)
    try:
        eng.run()
    except JStallError as e:
        return eng, str(e)
    return eng, None


#: per rank count, the runs of its group: name -> (mesh (node, data),
#: nodes, systems, instructions, snapshots, engine keywords)
RUNS = {
    2: {"1x2": ((2, 1), 8, 4, 12, True, {}),
        "22 nodes split": ((2, 1), 22, 2, 8, False, {}),
        "overflow": ((2, 1), 8, 4, 12, True, {"exchange_slots": 1})},
    8: {"2x4": ((4, 2), 8, 4, 12, True, {}),
        "4x2 snapshots off": ((2, 4), 8, 4, 12, False, {}),
        "windowed": ((4, 2), 8, 4, 12, False, {"trace_window": 8}),
        "fused i32": ((4, 2), 8, 4, 12, False,
                      {"schedule": Schedule(), "trace_window": 8}),
        "fused packed": ((4, 2), 8, 4, 12, False,
                         {"schedule": Schedule(), "trace_window": 8,
                          "packed": True})},
}


@functools.lru_cache(maxsize=None)
def _spawned(d):
    """One spawned group of ``d`` gloo ranks running ``RUNS[d]``, once a
    process: {name: (engine, its StallError message or None)}."""
    engs = {}
    for name, ((node, data), n, b, t, snap, kw) in RUNS[d].items():
        engs[name] = NodeShardedCudaEngine(
            _cfgs(n)[1], *_arrays(n, b, t), mesh=make_mesh(
                node_shards=node, data_shards=data, device="cpu"),
            snapshots=snap, **dict(KW, **kw))
    errors = {}
    # the overflow run raises at its check: run it after the others
    order = sorted(engs, key=lambda k: k == "overflow")
    try:
        run_node_sharded([engs[k] for k in order])
    except StallError as e:
        errors["overflow"] = str(e)
    return {k: (e, errors.get(k)) for k, e in engs.items()}


@pytest.fixture
def group(request):
    d = request.param
    if len(jax.devices()) < d:
        pytest.skip(f"needs {d} virtual devices")
    return _spawned(d)


def _stats(s):
    return {k: v for k, v in s.items() if not k.startswith("exchange_")}


def _assert_equal(shd, ref, transients=None):
    """Every plane of ``ref`` (and, with ``transients``, the JAX sharded
    engine's eight rows), cycle, counters, ``stats()`` and dumps.  A run
    without snapshots is held against the snapshot run's other planes
    (phase D writes only the ``snap_`` planes)."""
    for f, v in ref.state.items():
        if f.startswith("snap_") and not shd._snapshots:
            assert f not in shd.state
            continue
        assert np.array_equal(np.asarray(v), shd.state[f].numpy()), f
    if transients is not None:
        for f in TRANSIENTS:
            assert np.array_equal(np.asarray(transients.state[f]),
                                  shd.state[f].numpy()), f
        assert shd.stats() == transients.stats()
        assert shd.cross_shard_msgs == transients.cross_shard_msgs
    assert shd.cycle == ref.cycle
    assert shd.instructions == ref.instructions
    assert shd.messages == ref.messages
    assert _stats(shd.stats()) == _stats(ref.stats())
    for s in range(ref.b):
        assert dicts(shd.system_final_dumps(s)) == dicts(
            ref.system_final_dumps(s))


@pytest.mark.parametrize("group,name,jax_mesh", [
    (2, "1x2", (2, 1)), (8, "2x4", (4, 2)),
    (8, "4x2 snapshots off", None)], indirect=["group"])
def test_bit_exact_vs_single_device(group, name, jax_mesh):
    """``tests/test_node_sharded_pallas.py:87-125``: a data x node mesh,
    snapshots on (1x2, 2x4) and off (4x2), equal to interpreted
    ``PallasEngine``; where JAX ran the same mesh, the transient rows and
    the ``exchange_*`` stats equal its ``NodeShardedPallasEngine``'s."""
    eng, err = group[name]
    assert err is None
    node, data = RUNS[8 if name != "1x2" else 2][name][0]
    assert (eng.node_shards, eng.data_shards) == (node, data)
    jref = _jax_sharded(*jax_mesh)[0] if jax_mesh else None
    _assert_equal(eng, _interpreted(), jref)
    assert eng.cross_shard_msgs > 0
    stats = eng.stats()
    assert stats["exchange_sent"] == eng.cross_shard_msgs
    assert stats["exchange_slot_hwm"] >= 1
    assert stats["exchange_bytes_per_cycle"] > 0
    # one host read a k-cycle call, plus the window's seed gate and the
    # final status read, on every rank
    for st in eng.rank_stats:
        assert st["host_syncs"] == st["calls"] + 2


@pytest.mark.parametrize("group", [2], indirect=True)
def test_split_plane_22_nodes(group):
    """22 nodes (split sharer planes, per-word masks and feedback) over
    two ranks equal interpreted ``PallasEngine`` at 22 x 2 x 8 and the
    JAX sharded run's transient rows."""
    eng, err = group["22 nodes split"]
    assert err is None
    ref = _interpreted(22, 2, 8, seed=1, snapshots=False)
    jref = _jax_sharded(2, 1, 22, 2, 8, snapshots=False)[0]
    _assert_equal(eng, ref, jref)


@pytest.mark.parametrize("group,packed", [(8, False), (8, True)],
                         ids=["i32", "packed"], indirect=["group"])
def test_fused_schedule_bit_exact(group, packed):
    """``tests/test_node_sharded_pallas.py:186-209``: the fused occupancy
    scheduler over a 2 x 4 grid reproduces the unscheduled sharded run's
    dumps and instructions on the same windows (one device program, no
    host barrier), and equals JAX's sharded fused run in every plane and
    transient row."""
    eng, err = group["fused packed" if packed else "fused i32"]
    assert err is None
    assert eng.occupancy.device_programs == 1
    assert eng.occupancy.host_barriers == 0
    ref, err = group["windowed"]
    assert err is None
    for s in range(ref.b):
        assert dicts(eng.system_final_dumps(s)) == dicts(
            ref.system_final_dumps(s))
    assert eng.instructions == ref.instructions
    jeng = NodeShardedPallasEngine(
        _cfgs()[0], *_arrays(), node_shards=4, data_shards=2,
        snapshots=False, trace_window=8, schedule=JSchedule(),
        packed=packed, **KW).run()
    for f in list(jeng.state):
        assert np.array_equal(np.asarray(jeng.state[f]),
                              eng.state[f].numpy()), f
    assert eng.occupancy.as_dict() == jeng.occupancy.as_dict()


@pytest.mark.parametrize("group", [2], indirect=True)
def test_exchange_slots_overflow_is_loud(group):
    """``tests/test_node_sharded_pallas.py:215-230``: a one-slot exchange
    buffer fails the whole run with the JAX package's message, naming
    the worst cycle, shard pair and demand."""
    eng, err = group["overflow"]
    _, jerr = _jax_sharded(2, 1, slots=1)
    assert err is not None and err == jerr
    assert "exchange_slots=1" in err and "worst cycle" in err
    assert "demanded" in err
    with pytest.raises(StallError, match="mid-flight"):
        eng.run()


def test_geometry_validation():
    """``tests/test_node_sharded_pallas.py:236-250``, and the port's
    own: one rank is the unsharded path, more ranks than cards and the
    ablation raise."""
    tcfg = _cfgs()[1]
    arrays = _arrays()

    def mk(**kw):
        return NodeShardedCudaEngine(tcfg, *arrays, device="cpu", **kw)

    with pytest.raises(ValueError, match="not divisible by node"):
        mk(node_shards=3)
    with pytest.raises(ValueError, match="data_shards"):
        mk(node_shards=2, data_shards=3)
    with pytest.raises(ValueError, match="unsharded fast path"):
        mk(node_shards=1)
    with pytest.raises(NotImplementedError, match="fused"):
        mk(node_shards=2, schedule=Schedule(fused=False))
    with pytest.raises(ValueError, match="node_shards or an explicit mesh"):
        mk()
    with pytest.raises(ValueError, match="single-node-shard"):
        mk(node_shards=2, _ablate=frozenset({"phase_a"}))
    with pytest.raises(ValueError, match="out of range"):
        from hpa2_tpu_torch.ops.cycle import build_cycle

        class Comm:
            size, rank = 2, 0

            def all_reduce(self, x, op):
                return x

        build_cycle(tcfg, axis_name=Comm(), shards=2, exchange_slots=21)
