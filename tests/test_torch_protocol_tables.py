"""The port's copies of the JAX package's jax-free tables against the
originals: the declarative transition tables and their static checks,
the compiled protocol planes (``planes_for``) of every protocol under
default and robust semantics, the topologies at 4, 6 and 9 nodes, the
directory formats, and the sharer-word primitives of ``ops/bits.py``
(int32 bit patterns against JAX's uint32 words)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpa2_tpu.analysis.checks import run_static_checks as j_checks
from hpa2_tpu.analysis.table import build_table as j_build_table
from hpa2_tpu.config import Semantics as JSemantics
from hpa2_tpu.interconnect.topology import build_topology as j_topology
from hpa2_tpu.ops import bits as jbits
from hpa2_tpu.protocols.compiler import planes_for as j_planes
from hpa2_tpu.protocols.directory import (
    group_mask_words as j_group_mask_words, parse_format as j_parse_format,
)
from hpa2_tpu_torch.analysis.checks import run_static_checks
from hpa2_tpu_torch.analysis.table import build_table
from hpa2_tpu_torch.config import Semantics
from hpa2_tpu_torch.interconnect.topology import TOPOLOGIES, build_topology
from hpa2_tpu_torch.ops import bits
from hpa2_tpu_torch.protocols.compiler import planes_for
from hpa2_tpu_torch.protocols.directory import (
    group_mask_words, parse_format,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PROTOCOLS = ("mesi", "moesi", "mesif")
SEMANTICS = {"default": (JSemantics(), Semantics()),
             "robust": (JSemantics().robust(), Semantics().robust())}


@pytest.mark.parametrize("sem", sorted(SEMANTICS))
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_planes_match_jax(protocol, sem):
    jsem, tsem = SEMANTICS[sem]
    want, got = j_planes(protocol, jsem), planes_for(protocol, tsem)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.digest() == want.digest()


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_tables_and_checks_match_jax(protocol):
    jsem, tsem = SEMANTICS["robust"]
    want, got = j_build_table(jsem, protocol), build_table(tsem, protocol)
    strip = lambda t: {k: v for k, v in dataclasses.asdict(t).items()
                       if k != "semantics"}
    assert strip(got) == strip(want)
    assert [dataclasses.asdict(f) for f in run_static_checks(got)] == [
        dataclasses.asdict(f) for f in j_checks(want)]


@pytest.mark.parametrize("n", [4, 6, 9])
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_topology_matches_jax(name, n):
    want, got = j_topology(name, n, 2), build_topology(name, n, 2)
    assert got.link_names == want.link_names
    for f in ("link_latency", "hops", "base_lat", "path_mat"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("param,n", [(2, 8), (4, 8), (4, 9), (3, 31)])
def test_group_mask_words_match_jax(param, n):
    w = (n + 31) // 32
    assert np.array_equal(group_mask_words(param, n, w, 32),
                          j_group_mask_words(param, n, w, 32))


@pytest.mark.parametrize("fmt", ["full", "limited:2", "coarse:4",
                                 "limited:0", "coarse:x", "sparse"])
def test_parse_format_matches_jax(fmt):
    def outcome(fn):
        try:
            return fn(fmt, 8)
        except ValueError as e:
            return str(e)
    assert outcome(parse_format) == outcome(j_parse_format)


def test_sharer_word_primitives_match_jax():
    """popcount, the lowest set bit, one-hot masks and bit tests on
    words with bit 31 set, as int32 bits against JAX's uint32."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, (200, 3), dtype=np.uint64).astype(
        np.uint32)
    words[:20] = 0
    words[20:40, 0] = 0x80000000
    words[40:60, 1:] = 0
    tw = torch.from_numpy(words.view(np.int32))
    jw = jnp.asarray(words)
    assert np.array_equal(bits.popcount(tw).numpy(),
                          np.asarray(jbits.popcount(jw)))
    assert np.array_equal(bits.find_owner(tw).numpy(),
                          np.asarray(jbits.find_owner(jw)))
    procs = np.arange(-2, 96, dtype=np.int32)
    assert np.array_equal(
        bits.bit_mask(torch.from_numpy(procs), 3).numpy().view(np.uint32),
        np.asarray(jbits.bit_mask(jnp.asarray(procs), 3)))
    p = rng.integers(-1, 96, 200).astype(np.int32)
    assert np.array_equal(bits.test_bit(tw, torch.from_numpy(p)).numpy(),
                          np.asarray(jbits.test_bit(jw, jnp.asarray(p))))
    assert all(bits.to_int(tw[i]) == jbits.to_int(words[i])
               for i in range(0, 200, 7))
