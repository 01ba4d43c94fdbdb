"""``hpa2_tpu_torch.ops.prng`` against ``jax.random`` (threefry2x32,
partitionable mode, as the installed jax runs it): keys, splits,
fold-ins and uniform draws bit for bit, batched over keys as the
general engine draws them; and the retransmission-count thresholds the
step compares its draws with, against the float32 formula of the JAX
step on the same draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpa2_tpu_torch.ops import prng
from hpa2_tpu_torch.ops.step import failure_thresholds
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEEDS = [0, 1, 7, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1, -1]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _port_key(key) -> torch.Tensor:
    return torch.from_numpy(np.array(key).view(np.int32))


def test_mode_is_the_one_the_port_reproduces():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    assert np.array_equal(_u32(prng.PRNGKey(seed)),
                          np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", [0, 42, 2**31 + 3])
def test_split_and_split_last(seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.split(key, 5))
    assert np.array_equal(_u32(prng.split(_port_key(key), 5)), want)
    assert np.array_equal(_u32(prng.split_last(_port_key(key), 5)), want[4])
    assert np.array_equal(_u32(prng.split(_port_key(key), 3)),
                          np.asarray(jax.random.split(key, 3)))


def test_fold_in_over_an_arange():
    """``init_state_batched``'s per-system keys."""
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        key, jnp.arange(37)))
    got = prng.fold_in(_port_key(key), torch.arange(37))
    assert np.array_equal(_u32(got), want)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (7, 41), (8, 40),
                                   (13, 65)])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (1e-37, 1.0)])
def test_uniform(shape, bounds):
    key = jax.random.fold_in(jax.random.PRNGKey(3), shape[1])
    want = np.asarray(jax.random.uniform(key, shape, minval=bounds[0],
                                         maxval=bounds[1]))
    got = prng.uniform(_port_key(key), shape, *bounds).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_batched_keys_split_and_draw():
    """A batch of keys, each split and drawn from as the step does."""
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.PRNGKey(7), jnp.arange(6))
    pk = _port_key(keys)
    want_split = np.asarray(jax.vmap(lambda k: jax.random.split(k, 5))(keys))
    assert np.array_equal(_u32(prng.split(pk, 5)), want_split)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (4, 20), minval=1e-37))(keys))
    got = prng.uniform(pk, (4, 20), minval=1e-37).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("p", [0.05, 0.2, 0.5, 0.9])
def test_failure_thresholds_match_the_float32_formula(p):
    """The retransmission count from the thresholds equals
    ``min(floor(log(u) / log(p)), 64)`` in float32 (the JAX step's
    formula) on a million draws."""
    u = jax.random.uniform(jax.random.PRNGKey(11), (1_000_000,),
                           minval=1e-37, maxval=1.0)
    want = np.asarray(jnp.minimum(
        jnp.floor(jnp.log(u) / jnp.log(p)).astype(jnp.int32), 64))
    thr = failure_thresholds(p, 64)
    got = (thr.shape[0] - torch.searchsorted(
        thr, torch.from_numpy(np.array(u)), side="left")).numpy()
    assert np.array_equal(got, want)
