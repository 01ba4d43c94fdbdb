"""The eviction ping-pong workload on the port: its generator against
the JAX package's, the adversarial liveness sweep of
``tests/test_random_differential.py`` (l.209-224) on the port's engines
(``tests/torch_differential.py``), and, under ``-m slow``, the
analyzer's random-corruption fuzz of ``tests/test_protocol_fuzz.py``
through the port's ``mutate.run_fuzz(device="cpu")``.

The workload is the reference's hang class (SURVEY.md §6.3): every
address collides at cache index 0 and homes share their own hot lines.
Tiny mailboxes can deadlock under it; the engines must agree on which
systems do."""

import numpy as np
import pytest

from hpa2_tpu.utils import trace as jtrace
from hpa2_tpu_torch.analysis.mutate import run_fuzz
from hpa2_tpu_torch.config import Semantics
from hpa2_tpu_torch.utils import trace
from torch_differential import ADVERSARIAL_GEOMETRIES, geometry, sweep
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("gi", range(len(ADVERSARIAL_GEOMETRIES)))
def test_pingpong_arrays_equal_the_jax_generator(gi):
    dims, batch, t, _ = ADVERSARIAL_GEOMETRIES[gi]
    jcfg, tcfg = geometry(*dims)
    want = jtrace.gen_eviction_pingpong_arrays(jcfg, batch, t,
                                               seed=7000 + gi)
    got = trace.gen_eviction_pingpong_arrays(tcfg, batch, t, seed=7000 + gi)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # the per-system traces and the keywords too
    for kw in ({}, {"hot_homes": 1, "write_frac": 0.3}):
        a = trace.gen_eviction_pingpong(tcfg, t, seed=gi, **kw)
        b = jtrace.gen_eviction_pingpong(jcfg, t, seed=gi, **kw)
        assert [[(x.op, x.address, x.value) for x in tr] for tr in a] == \
            [[(x.op, x.address, x.value) for x in tr] for tr in b]


def test_pingpong_refuses_a_cache_larger_than_memory():
    _, tcfg = geometry(4, 8, 4, 8)
    with pytest.raises(ValueError, match="cache_size <= mem_size"):
        trace.gen_eviction_pingpong(tcfg, 4)


@pytest.mark.sweep
@pytest.mark.parametrize("gi", range(len(ADVERSARIAL_GEOMETRIES)))
def test_adversarial_liveness_geometry(gi, tmp_path):
    dims, batch, t, extra = ADVERSARIAL_GEOMETRIES[gi]
    jcfg, tcfg = geometry(*dims)
    arrays = jtrace.gen_eviction_pingpong_arrays(jcfg, batch, t,
                                                 seed=7000 + gi)
    stalled = sweep(jcfg, tcfg, batch, extra, arrays, tmp_path,
                    allow_stall=tcfg.msg_buffer_size <= 6)
    if dims[3] == 4:  # the deadlock is reached: stall agreement is tested
        assert any(stalled)


FUZZ_COUNT = 150


@pytest.mark.slow
@pytest.mark.parametrize("protocol", ["mesi", "moesi", "mesif"])
@pytest.mark.parametrize("semname", ["default", "robust"])
def test_every_random_corruption_is_caught(protocol, semname):
    sem = Semantics() if semname == "default" else Semantics().robust()
    results = run_fuzz(sem, protocol, seed=2024, count=FUZZ_COUNT,
                       device="cpu")
    missed = [r.name for r in results if not r.caught]
    assert not missed, (
        f"[{semname}/{protocol}] analyzer missed "
        f"{len(missed)}/{FUZZ_COUNT} corruptions: {missed[:10]}")


@pytest.mark.slow
def test_fuzz_exercises_both_catchers():
    results = run_fuzz(Semantics().robust(), "moesi", seed=7, count=80,
                       device="cpu")
    by = {r.caught_by for r in results}
    assert "static" in by and "spec-diff" in by, by


@pytest.mark.slow
def test_fuzz_is_deterministic():
    a = run_fuzz(Semantics(), "mesif", seed=3, count=25, with_jax=False,
                 device="cpu")
    b = run_fuzz(Semantics(), "mesif", seed=3, count=25, with_jax=False,
                 device="cpu")
    assert [r.name for r in a] == [r.name for r in b]
