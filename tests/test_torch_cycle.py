"""The port's plain cycle (``hpa2_tpu_torch.ops.cycle``) against the JAX
cycle body (``hpa2_tpu.ops.pallas_engine.build_cycle``), one cycle at a
time.

States come from running the jitted JAX cycle from ``_init_state`` on
seeded random traces; each one is carried into the port with
``hpa2_tpu_torch.convert`` and advanced one cycle by both packages.
Every plane must agree bit for bit (all state is integer)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hpa2_tpu.ops import pallas_engine as jpe
from hpa2_tpu.utils.trace import gen_uniform_random_arrays
from hpa2_tpu_torch.convert import state_from_numpy, state_to_numpy
from hpa2_tpu_torch.ops.cycle import build_cycle
from torch_pairs import config_pair


def jax_trajectory(jcfg, b, t, seed, snapshots, cycles, packed=False):
    """States [s_0 .. s_cycles] of the JAX cycle (numpy dicts, with the
    trace planes)."""
    op, addr, val, length = gen_uniform_random_arrays(jcfg, b, t, seed=seed)
    st = jpe._init_state(jcfg, b, snapshots, packed)
    st["tr"] = jpe._pack_traces(jcfg, op, addr, val, length)
    st["tr_len"] = np.ascontiguousarray(length.T)
    step = jax.jit(jpe.build_cycle(jcfg, b, snapshots, packed=packed))
    cur = {f: jnp.asarray(v) for f, v in st.items()}
    out = [st]
    for _ in range(cycles):
        cur = step(cur)
        out.append({f: np.asarray(v) for f, v in cur.items()})
    return out


@pytest.mark.parametrize(
    "n,cap,robust,snapshots,seed",
    [
        (4, 4, True, True, 0),      # backpressure: deferred sends
        (4, 32, False, False, 1),   # fixture ("drop") semantics
        (8, 32, True, False, 2),
        (8, 4, False, True, 3),
    ],
)
def test_one_cycle_matches_jax(n, cap, robust, snapshots, seed):
    jcfg, tcfg = config_pair(robust, num_procs=n, msg_buffer_size=cap)
    traj = jax_trajectory(jcfg, b=6, t=12, seed=seed, snapshots=snapshots,
                          cycles=60)
    cycle = build_cycle(tcfg, snapshots)
    busy = 0
    for i, (before, after) in enumerate(zip(traj[:-1], traj[1:])):
        got = state_to_numpy(cycle(state_from_numpy(before, "cpu")))
        assert set(got) == set(after)
        for f in after:
            np.testing.assert_array_equal(
                got[f], after[f], err_msg=f"cycle {i}, plane {f!r}")
        busy += int(np.any(before["nsw"] != after["nsw"]))
    # the trajectory really exercised the protocol
    assert busy > 10
    assert traj[-1]["scalars"][jpe._SC_MSGS].sum() > 0


@pytest.mark.parametrize(
    "n,c,m,cap,snapshots,packed,seed",
    [
        (22, 2, 4, 16, True, False, 4),    # split sharer planes, SW=1
        (22, 2, 4, 4, False, True, 5),     # split and packed, deferrals
        (4, 2, 8, 4, True, True, 6),       # packed u8 meta planes
        (8, 4, 16, 16, False, True, 7),    # packed u16 meta planes
    ],
)
def test_one_cycle_split_packed_matches_jax(n, c, m, cap, snapshots, packed,
                                            seed):
    jcfg, tcfg = config_pair(True, num_procs=n, cache_size=c, mem_size=m,
                             msg_buffer_size=cap)
    traj = jax_trajectory(jcfg, b=3, t=8, seed=seed, snapshots=snapshots,
                          cycles=40, packed=packed)
    cycle = build_cycle(tcfg, snapshots, packed)
    for i, (before, after) in enumerate(zip(traj[:-1], traj[1:])):
        got = state_to_numpy(cycle(state_from_numpy(before, "cpu")))
        assert set(got) == set(after)
        for f in after:
            assert got[f].dtype == after[f].dtype, f
            np.testing.assert_array_equal(
                got[f], after[f], err_msg=f"cycle {i}, plane {f!r}")
    assert traj[-1]["scalars"][jpe._SC_MSGS].sum() > 0
