"""The port's targeted exchange (``hpa2_tpu_torch/ops/exchange.py``)
against the JAX package's (``hpa2_tpu/ops/exchange.py``) on seeded
numpy inputs: ``compact``/``uncompact``, ``ordered_rank``,
``range_mask_words`` (32 and 21 bits a word), ``make_plan`` and
``plan_collectives``; then ``forward``/``feedback`` in every mode on 2
and 4 gloo ranks against the same exchange under ``shard_map`` on the
virtual CPU mesh: the received blocks, their origins, the feedback on
the local candidates, the telemetry, and the collectives of each
case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from hpa2_tpu import hostenv
from hpa2_tpu.ops import exchange as jx
from hpa2_tpu_torch.ops import exchange as tx
from hpa2_tpu_torch.parallel.launch import spawn
from torch_ranks import FSTATS, exchange_dest, exchange_fan, exchange_rank
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODES = ("pairwise", "a2a", "butterfly", "hier")
R, J, T = 8, 6, 2


@pytest.mark.parametrize("k", [J, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_compact_and_uncompact_match_jax(seed, k):
    rng = np.random.default_rng(seed)
    dest = rng.random((J, T)) < 0.5
    payload = rng.integers(-2**31, 2**31, (R, J, T), dtype=np.int64
                           ).astype(np.int32)
    jbuf, jsel, jovf = jx.compact(jnp.asarray(dest), jnp.asarray(payload), k)
    buf, sel, ovf = tx.compact(torch.from_numpy(dest),
                               torch.from_numpy(payload), k)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(jovf))
    onehot = (sel.numpy()[:, None] == np.arange(k)[None, :, None])
    np.testing.assert_array_equal(onehot.astype(np.int32), np.asarray(jsel))
    fb = rng.integers(-2**31, 2**31, (2, k, T), dtype=np.int64
                      ).astype(np.int32)
    np.testing.assert_array_equal(
        tx.uncompact(torch.from_numpy(fb), sel).numpy(),
        np.asarray(jx.uncompact(jnp.asarray(fb), jsel)))


@pytest.mark.parametrize("seed", range(4))
def test_ordered_rank_matches_jax(seed):
    rng = np.random.default_rng(seed)
    nb = int(rng.integers(1, 5))
    widths = rng.integers(1, 5, nb)
    bounds = [0] + list(np.cumsum(widths))
    origins = list(rng.permutation(nb))
    shape = (3, 4, bounds[-1])
    va = rng.random(shape) < 0.4
    vb = ~va & (rng.random(shape) < 0.5)
    want = jx.ordered_rank(jnp.asarray(va), jnp.asarray(vb), bounds,
                           [jnp.int32(o) for o in origins], axis=2)
    got = tx.ordered_rank(torch.from_numpy(va), torch.from_numpy(vb),
                          bounds, origins, axis=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bpw", [32, 21])
def test_range_mask_words_match_jax(bpw):
    for nwords in (1, 2, 3):
        top = nwords * bpw
        for lo in range(0, top + 1, 5):
            for hi in (lo, lo + 1, lo + 7, top, top + 3):
                want = np.asarray(jx.range_mask_words(
                    jnp.int32(lo), jnp.int32(hi), nwords, bpw))
                got = tx.range_mask_words(lo, hi, nwords, bpw).numpy()
                np.testing.assert_array_equal(got.view(np.uint32), want,
                                              err_msg=f"{lo}..{hi}")


def test_plans_and_collectives_match_jax():
    for d in range(1, 9):
        for mode in MODES:
            for inner in (0, 1, 2, 3):
                try:
                    want = jx.make_plan(d, mode, inner)
                except ValueError as e:
                    with pytest.raises(ValueError) as got:
                        tx.make_plan(d, mode, inner)
                    assert str(got.value) == str(e)
                    continue
                got = tx.make_plan(d, mode, inner)
                assert tuple(got) == tuple(want)
                assert tx.plan_collectives(got) == jx.plan_collectives(want)
    with pytest.raises(ValueError, match="unknown exchange_mode"):
        tx.make_plan(2, "ring")


def _payloads(d, seed):
    rng = np.random.default_rng(seed)
    p = rng.integers(-2**31, 2**31, (d, R, J, T), dtype=np.int64
                     ).astype(np.int32)
    p[:, 2] = rng.integers(0, 1 << d, (d, J, T))   # destination set
    p[:, 3] = rng.integers(0, 4, (d, J, T))        # fan count
    p[:, 4] = rng.integers(0, 9, (d, J, T))        # combining key
    return p


def _jax_exchange(d, mode, inner, k, payloads):
    mesh = Mesh(np.array(jax.devices()[:d]), ("x",))
    plan = jx.make_plan(d, mode, inner)

    def body(p):
        me = jax.lax.axis_index("x")
        bufs, origins, ctx, fs = jx.forward(
            plan, "x", me, p[0], exchange_dest, k, fan_fn=exchange_fan,
            ckey_row=4, nkeys=8)
        acc = jx.feedback(plan, "x", [b[5:7] for b in bufs], ctx)
        return (jnp.stack(bufs)[None],
                jnp.stack([jnp.asarray(o, jnp.int32) for o in origins])[None],
                acc[None], jnp.stack([fs[key] for key in FSTATS])[None])

    fn = hostenv.shard_map(body, mesh=mesh, in_specs=(P("x"),),
                           out_specs=(P("x"),) * 4, check_replication=False)
    return [np.asarray(x) for x in jax.jit(fn)(jnp.asarray(payloads))]


def _cases(d):
    cases = []
    for i, mode in enumerate(MODES):
        if mode == "butterfly" and d & (d - 1):
            continue
        for k in (J, 2):  # capacity-exact, and a tight buffer
            cases.append((mode, 2 if mode == "hier" and d == 4 else 0, k,
                          _payloads(d, 10 * d + i)))
    return cases


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request):
    d = request.param
    if len(jax.devices()) < d:
        pytest.skip(f"needs {d} virtual devices")
    cases = _cases(d)
    return d, cases, spawn(exchange_rank, d, args=(cases,), device="cpu")


@pytest.mark.parametrize("mode", MODES)
def test_forward_feedback_match_shard_map(ranks, mode):
    d, cases, got = ranks
    n = 0
    for c, (m, inner, k, payloads) in enumerate(cases):
        if m != mode:
            continue
        n += 1
        bufs, origins, acc, fs = _jax_exchange(d, m, inner, k, payloads)
        plan = tx.make_plan(d, m, inner)
        for r in range(d):
            mine = got[r][c]
            np.testing.assert_array_equal(mine["bufs"], bufs[r])
            assert mine["origins"] == list(origins[r])
            np.testing.assert_array_equal(mine["acc"], acc[r])
            np.testing.assert_array_equal(mine["fs"], fs[r])
            coll = mine["collectives"]
            assert {key: coll[key] for key in ("ppermute", "all_to_all")} \
                == tx.plan_collectives(plan)
            assert coll["sum"] == coll["max"] == coll["min"] == 0
    assert n or (mode == "butterfly" and d & (d - 1))


def test_exchange_refuses_a_mesh_axis_name():
    from hpa2_tpu_torch.config import SystemConfig
    from hpa2_tpu_torch.ops.step import build_step

    with pytest.raises(ValueError, match="NodeComm"):
        build_step(SystemConfig(num_procs=4), axis_name="node", shards=2)
    assert torch.get_num_threads() == 1
