"""The port's cross-backend table extraction
(``hpa2_tpu_torch/analysis/extract.py``) against the JAX package's
(``hpa2_tpu/analysis/extract.py``), on the CPU.

Every probeable row of the declared tables is staged as one concrete
single-transition scenario.  The port's probers must observe exactly
what the JAX probers observe on the same scenario: the ``pallas``
prober (one cycle of the per-call kernel K3's plain version, every row
a lane of one call) against the JAX ``PallasProber`` (one cycle of the
Pallas program in interpret mode, one row a call), the ``jax`` prober
(the general engine's step, every row a system of one batch) against
``JaxProber``, and the ``spec`` and ``native`` probes against theirs.
Tolerance zero: every observed field is an integer.  Then every
backend the JAX ``equiv`` runs must show 0 diffs against the declared
table, and a corrupted table must show diffs on the port's probers.
"""

import dataclasses

import pytest

from hpa2_tpu.analysis import extract as jx_extract
from hpa2_tpu.analysis.table import build_table as jx_build_table
from hpa2_tpu.config import Semantics as JxSemantics
from hpa2_tpu_torch.analysis import extract
from hpa2_tpu_torch.analysis.table import build_table
from hpa2_tpu_torch.config import Semantics
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEMS = {
    "default": (Semantics(), JxSemantics()),
    "robust": (Semantics().robust(), JxSemantics().robust()),
    "head": (Semantics().head_quirks(), JxSemantics().head_quirks()),
}
PROTOCOLS = ("mesi", "moesi", "mesif")


def _scenarios(name, protocol="mesi"):
    table = build_table(SEMS[name][0], protocol)
    return [extract.scenario_for(r, protocol)
            for r in extract.probeable_rows(table)]


def _jx(scn):
    return jx_extract.Scenario(**dataclasses.asdict(scn))


def _same(port_obs, jax_obs):
    return dataclasses.asdict(port_obs) == dataclasses.asdict(jax_obs)


def _mismatches(scns, port, jax):
    return [(s, dataclasses.asdict(p), dataclasses.asdict(j))
            for s, p, j in zip(scns, port, jax) if not _same(p, j)][:3]


@pytest.mark.parametrize("name", ["default", "robust"])
def test_pallas_prober_equals_jax_pallas_prober(name):
    """One cycle of K3's plain version, every row a lane of one call,
    equals the JAX Pallas program in interpret mode, one row a call."""
    scns = _scenarios(name)
    port = extract.PallasProber(SEMS[name][0], device="cpu")
    got = port.probe_many(scns)
    assert port.launches == 1
    jx = jx_extract.PallasProber(SEMS[name][1])
    want = [jx.probe(_jx(s)) for s in scns]
    assert len(scns) >= 100
    assert not _mismatches(scns, got, want)


@pytest.mark.parametrize("protocol", PROTOCOLS)
@pytest.mark.parametrize("name", ["default", "robust"])
def test_jax_prober_equals_jax_jax_prober(name, protocol):
    scns = _scenarios(name, protocol)
    got = extract.JaxProber(SEMS[name][0], protocol,
                            device="cpu").probe_many(scns)
    jx = jx_extract.JaxProber(SEMS[name][1], protocol)
    want = [jx.probe(_jx(s)) for s in scns]
    assert not _mismatches(scns, got, want)


def _tables():
    """(semantics, protocol) of every table: the HEAD quirk is a MESI
    fixture quirk, which the MOESI and MESIF tables do not model."""
    return [(name, protocol) for name in sorted(SEMS)
            for protocol in PROTOCOLS
            if name != "head" or protocol == "mesi"]


@pytest.mark.parametrize("name,protocol", _tables())
def test_spec_probe_equals_jax_spec_probe(name, protocol):
    scns = _scenarios(name, protocol)
    port, jax = SEMS[name]
    got = [extract.probe_spec(s, port, protocol) for s in scns]
    want = [jx_extract.probe_spec(_jx(s), jax, protocol) for s in scns]
    assert not _mismatches(scns, got, want)


@pytest.mark.parametrize("name", sorted(SEMS))
def test_native_probe_equals_jax_native_probe(name):
    scns = _scenarios(name)
    port, jax = SEMS[name]
    got = [extract.probe_native(s, port) for s in scns]
    want = [jx_extract.probe_native(_jx(s), jax) for s in scns]
    assert not _mismatches(scns, got, want)


@pytest.mark.parametrize("name", ["default", "robust"])
def test_batched_pallas_probe_equals_one_lane_probes(name):
    """Rows as lanes of one call equal each row alone (a lane block of
    one lane): the lanes are independent systems."""
    scns = _scenarios(name)
    prober = extract.PallasProber(SEMS[name][0], device="cpu")
    batched = prober.probe_many(scns)
    single = [prober.probe(s) for s in scns]
    assert prober.launches == 1 + len(scns)
    assert batched == single


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_batched_jax_probe_equals_one_system_probes(protocol):
    scns = _scenarios("robust", protocol)
    prober = extract.JaxProber(SEMS["robust"][0], protocol, device="cpu")
    assert prober.probe_many(scns) == [prober.probe(s) for s in scns]


def _equiv_cases():
    """(semantics, protocol, backend) wherever the JAX ``equiv`` runs
    the backend: native and pallas at MESI only, jax and pallas not
    under the overloaded HEAD quirk."""
    for name, protocol in _tables():
        for backend in ("spec", "jax", "native", "pallas"):
            if protocol != "mesi" and backend in ("native", "pallas"):
                continue
            if name == "head" and backend in ("jax", "pallas"):
                continue
            yield name, protocol, backend


@pytest.mark.parametrize("name,protocol,backend", list(_equiv_cases()))
def test_diff_backend_is_clean(name, protocol, backend):
    diffs = extract.diff_backend(build_table(SEMS[name][0], protocol),
                                 backend, device="cpu")
    assert not diffs, "\n".join(diffs[:20])


@pytest.mark.parametrize("protocol", PROTOCOLS)
@pytest.mark.parametrize("name", ["default", "robust"])
def test_multi_backend_is_clean_and_equals_jax(name, protocol):
    """The same-phase interaction scenarios: spec <-> the port's step
    is clean, and the port's step observes what the JAX step does."""
    port, jax = SEMS[name]
    assert not extract.diff_multi_backend(port, protocol, device="cpu")
    prober = extract.JaxProber(port, protocol, device="cpu")
    jprober = jx_extract.JaxProber(jax, protocol)
    for ms, jms in zip(extract.multi_scenarios(protocol, port),
                       jx_extract.multi_scenarios(protocol, jax)):
        assert ms.name == jms.name
        assert extract.probe_jax_multi(ms, prober) == \
            jx_extract.probe_jax_multi(jms, jprober), ms.name


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_device_probers_catch_a_corrupted_row(backend):
    """A table whose REPLY_WR fill reads the message payload instead of
    the pending write disagrees with what the step and K3 do: the diff
    names the row."""
    table = build_table(SEMS["robust"][0])
    row = table.row("cache", "I", "REPLY_WR", "any")
    bad = table.replaced(row, dataclasses.replace(row, value_src="msg"))
    diffs = extract.diff_backend(bad, backend, rows=[bad.row(*row.key)],
                                 device="cpu")
    assert diffs and all("cache/I/REPLY_WR/any" in d for d in diffs)


def test_probe_coverage_is_total_and_matches_jax():
    for name, protocol in _tables():
        rows = extract.probeable_rows(build_table(SEMS[name][0], protocol))
        jrows = jx_extract.probeable_rows(
            jx_build_table(SEMS[name][1], protocol))
        assert [r.key for r in rows] == [r.key for r in jrows]
        assert all(extract.scenario_for(r, protocol) is not None
                   for r in rows)


def test_device_probers_run_on_the_card_by_default():
    """Without ``device=`` the probers want the card, and raise without
    one (nothing falls back to the CPU)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        extract.PallasProber(SEMS["robust"][0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        extract.JaxProber(SEMS["robust"][0])
