"""The seeded random differential of ``tests/test_random_differential.py``
on the port's engines (``tests/torch_differential.py``): its uniform
geometries in the tier-1 suite and its slow tier under ``-m slow``.
Every port engine that takes a geometry gives each system the JAX
spec engine's and ``JaxEngine``'s final dumps and counters, and stalls
on exactly the systems they stall on."""

import pytest

from hpa2_tpu.utils.trace import gen_uniform_random_arrays
from torch_differential import GEOMETRIES, SLOW_GEOMETRIES, geometry, sweep
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.sweep
@pytest.mark.parametrize("gi", range(len(GEOMETRIES)))
def test_random_differential_geometry(gi, tmp_path):
    dims, batch, t, extra = GEOMETRIES[gi]
    jcfg, tcfg = geometry(*dims)
    arrays = gen_uniform_random_arrays(jcfg, batch, t, seed=1000 + gi)
    sweep(jcfg, tcfg, batch, extra, arrays, tmp_path,
          allow_stall=tcfg.msg_buffer_size <= 4)


@pytest.mark.slow
@pytest.mark.sweep
@pytest.mark.parametrize("gi", range(len(SLOW_GEOMETRIES)))
def test_slow_random_differential_geometry(gi, tmp_path):
    dims, batch, t, extra = SLOW_GEOMETRIES[gi]
    jcfg, tcfg = geometry(*dims)
    arrays = gen_uniform_random_arrays(jcfg, batch, t, seed=5000 + gi)
    sweep(jcfg, tcfg, batch, extra, arrays, tmp_path, allow_stall=False)
