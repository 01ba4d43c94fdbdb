"""Shared helpers of the ``test_torch_*`` files: one configuration built
in both packages, and the port's engine run beside ``PallasEngine`` on
the same traces."""

import warnings

import numpy as np
from jax.experimental.pallas import tpu as pltpu

from hpa2_tpu.config import Semantics as JSemantics
from hpa2_tpu.config import SystemConfig as JSystemConfig
from hpa2_tpu.models.protocol import Instr
from hpa2_tpu.models.spec_engine import SpecEngine
from hpa2_tpu.models.spec_engine import StallError as JStallError
from hpa2_tpu.ops.pallas_engine import PallasEngine
from hpa2_tpu_torch.config import Semantics, SystemConfig
from hpa2_tpu_torch.convert import state_to_numpy
from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
from hpa2_tpu_torch.ops.layout import StallError

#: the streamed JAX run reaches ``pltpu.ANY``, whose deprecation is the
#: JAX package's and not the port's
IGNORE_PLTPU_ANY = "ignore:pltpu.ANY is deprecated:DeprecationWarning"


def _settle_pltpu_any():
    """Look ``pltpu.ANY`` up once, with its deprecation ignored.

    jax caches a deprecated attribute of ``pltpu`` only after a lookup
    that did not raise, and ``pytest.ini`` raises the deprecation when
    ``hpa2_tpu`` reaches it. So whether a JAX test that builds the
    streamed path failed on it depended on whether a test that ignores
    it had run first in the same process. This module is imported while
    tests are collected, before any of them runs, so each process starts
    the run with the attribute settled and the outcome no longer depends
    on the order of the tests."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        getattr(pltpu, "ANY", None)


_settle_pltpu_any()


def config_pair(robust: bool, **kw):
    """The same configuration in both packages."""
    jsem, tsem = JSemantics(), Semantics()
    if robust:
        jsem, tsem = jsem.robust(), tsem.robust()
    return JSystemConfig(semantics=jsem, **kw), SystemConfig(
        semantics=tsem, **kw)


def traces_of(op, addr, val, length, b, n):
    """System ``b`` of ``[B, N, T]`` trace arrays as Instr lists."""
    return [
        [
            Instr("W", int(a), int(v)) if o == 1 else Instr("R", int(a))
            for o, a, v in zip(op[b, i, :length[b, i]],
                               addr[b, i, :length[b, i]],
                               val[b, i, :length[b, i]])
        ]
        for i in range(n)
    ]


def dicts(dumps):
    return [d.__dict__ for d in dumps]


def _run(eng, max_cycles, stall_type):
    try:
        eng.run(max_cycles)
    except stall_type as e:
        return str(e)
    return None


def run_both(jcfg, tcfg, arrays, max_cycles=1_000_000, stream=True, **kw):
    """``PallasEngine`` (interpreted; streamed unless ``stream=False``)
    and ``CudaEngine`` on the CPU over the same traces, with the same
    ``stream``.  Asserts that they stall alike and that every carried
    plane agrees; returns both engines and the stall message (None when
    the run completed)."""
    pe = PallasEngine(jcfg, *arrays, interpret=True, stream=stream, **kw)
    ce = CudaEngine(tcfg, *arrays, device="cpu", stream=stream, **kw)
    outcome = (_run(pe, max_cycles, JStallError),
               _run(ce, max_cycles, StallError))
    assert outcome[0] == outcome[1]
    got = state_to_numpy(ce.state)
    assert set(got) == set(pe.state)
    for f in got:
        np.testing.assert_array_equal(
            got[f], np.asarray(pe.state[f]), err_msg=f"plane {f!r}")
    return pe, ce, outcome[1]


def spec_on_windows(cfg, arrays, b, n, w, t):
    """The spec engine on the window schedule the engines run (``w``
    instructions per core per window, quiescent in between)."""
    traces = traces_of(*arrays, b, n)
    spec = SpecEngine(cfg, [tr[:w] for tr in traces])
    spec.run()
    for s in range(w, t, w):
        spec.continue_with([tr[s:s + w] for tr in traces])
        spec.run()
    return spec
