"""Checkpoints of the general engine's state on the port
(``hpa2_tpu_torch/utils/checkpoint.py``) against the JAX package's
(``hpa2_tpu/utils/checkpoint.py``), in the shapes of
``tests/test_checkpoint.py:43-160`` and ``tests/test_failover.py:383-400``:
the files are the same files, so a checkpoint written by either package
resumes in the other and ends equal to a straight run, field for field
(tolerance zero); ``latest_checkpoint``, the schema-v2 recovery
counters and the backfill of older files; and the ``bench
--checkpoint-every`` command's resume and refusal."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import hpa2_tpu.config as jconfig
from hpa2_tpu.ops.engine import JaxEngine
from hpa2_tpu.ops.engine import build_batched_run as jbuild_run
from hpa2_tpu.ops.engine import build_batched_run_chunk as jchunk
from hpa2_tpu.ops.state import init_state_batched as jinit_batched
from hpa2_tpu.ops.step import quiescent as jquiescent
from hpa2_tpu.utils import checkpoint as jck
from hpa2_tpu.utils.trace import gen_uniform_random, gen_uniform_random_arrays
from hpa2_tpu_torch import cli
from hpa2_tpu_torch.ops.engine import TorchEngine
from hpa2_tpu_torch.ops.step import build_batched_run_chunk, quiescent
from hpa2_tpu_torch.utils import checkpoint as tck
from torch_general import ACCEPT, ROBUST, port_config, port_traces, state_diff
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

JCFG = jconfig.SystemConfig(
    num_procs=4, semantics=ROBUST,
    interconnect=jconfig.InterconnectConfig(
        topology="mesh2d", fault=jconfig.FaultModel(**ACCEPT)),
    failures=jconfig.FailurePlan.parse("kill@3;hang@5:1", seed=4))
TCFG = port_config(JCFG)
META = {"batch": 3, "instrs": 24, "workload": "uniform", "seed": 0}


def _jstate(chunk=7):
    """A JAX batch advanced ``chunk`` simulated cycles."""
    st = jinit_batched(JCFG, *gen_uniform_random_arrays(JCFG, 3, 24, seed=0))
    return jchunk(JCFG, chunk)(st)


def _jstraight():
    st = jinit_batched(JCFG, *gen_uniform_random_arrays(JCFG, 3, 24, seed=0))
    return jax.tree_util.tree_map(lambda x: x.block_until_ready(),
                                  jbuild_run(JCFG, max_cycles=100_000)(st))


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_port_writes_the_jax_file(tmp_path):
    """The same state saved by both packages: the same keys, types,
    values and metadata; each loads the other's file back equal."""
    jst = _jstate()
    tst, _ = tck.load_state(_save_jax(tmp_path / "j.npz", jst), device="cpu")
    tck.save_state(str(tmp_path / "t.npz"), tst, TCFG, extra_meta=META)
    want, got = _npz(tmp_path / "j.npz"), _npz(tmp_path / "t.npz")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k
    back, cfg, meta = jck.load_state(str(tmp_path / "t.npz"), with_meta=True)
    assert cfg == JCFG and meta == jck.load_state(
        str(tmp_path / "j.npz"), with_meta=True)[2]
    assert state_diff(back, tst, batched=True) == []
    again, tcfg, tmeta = tck.load_state(str(tmp_path / "t.npz"),
                                        with_meta=True, device="cpu")
    assert tcfg == TCFG and tmeta["recovery"] == meta["recovery"]
    assert state_diff(jst, again, batched=True) == []


def _save_jax(path, st, meta=META):
    jck.save_state(str(path), st, JCFG, extra_meta=meta)
    return str(path)


def test_jax_checkpoint_resumes_on_the_port(tmp_path):
    """A JAX mid-run checkpoint, resumed by the port's chunk runner,
    ends in the state of JAX's straight run."""
    path = _save_jax(tmp_path / "mid.npz", _jstate(5))
    st, cfg = tck.load_state(path, device="cpu")
    run = build_batched_run_chunk(cfg, 5)
    while not bool(quiescent(st).all()):
        st = run(st)
    assert state_diff(_jstraight(), st, batched=True) == []


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """A port mid-run checkpoint, resumed by JAX's chunk program, ends
    in the state of JAX's straight run."""
    st, _ = tck.load_state(_save_jax(tmp_path / "start.npz", _jstate(0)),
                           device="cpu")
    run = build_batched_run_chunk(TCFG, 5)
    st = run(run(st))
    tck.save_state(str(tmp_path / "mid.npz"), st, TCFG)
    resumed, cfg = jck.load_state(str(tmp_path / "mid.npz"))
    assert cfg == JCFG
    chunk = jchunk(JCFG, 5)
    while not bool(jnp.all(jax.vmap(jquiescent)(resumed))):
        resumed = chunk(resumed)
    want = _jstraight()
    for name in want._fields:
        assert np.array_equal(np.asarray(getattr(want, name)),
                              np.asarray(getattr(resumed, name))), name


def test_single_system_checkpoint_crosses_packages(tmp_path):
    """``batched=False`` writes one system's state as ``JaxEngine``
    does; a ``JaxEngine`` file loads as a batch of one."""
    cfg = jconfig.SystemConfig(num_procs=4, semantics=ROBUST)
    traces = gen_uniform_random(cfg, 12, seed=3)
    je = JaxEngine(cfg, traces).run()
    te = TorchEngine(port_config(cfg), port_traces(traces),
                     device="cpu").run()
    tck.save_state(str(tmp_path / "t.npz"), te.state, port_config(cfg),
                   batched=False)
    jck.save_state(str(tmp_path / "j.npz"), je.state, cfg)
    want, got = _npz(tmp_path / "j.npz"), _npz(tmp_path / "t.npz")
    for k in want:
        if k.startswith("f_"):
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
    assert got["f_n_msgs"].shape == ()
    back, _ = tck.load_state(str(tmp_path / "j.npz"), device="cpu")
    assert back.n_msgs.shape == (1,)
    assert state_diff(je.state, back, batched=False) == []
    with pytest.raises(ValueError, match="batch of one"):
        tck.save_state(str(tmp_path / "x.npz"), _two(tmp_path), TCFG,
                       batched=False)


def _two(tmp_path):
    return tck.load_state(_save_jax(tmp_path / "two.npz", _jstate(0)),
                          device="cpu")[0]


def test_latest_checkpoint_and_refusals(tmp_path):
    st = _two(tmp_path)
    for k in (1, 3, 2):
        tck.save_state(str(tmp_path / f"ckpt_{k}.npz"), st, TCFG)
    (tmp_path / "ckpt_x.npz").write_bytes(b"")
    assert tck.latest_checkpoint(str(tmp_path)).endswith("ckpt_3.npz")
    assert tck.latest_checkpoint(str(tmp_path)) == jck.latest_checkpoint(
        str(tmp_path))
    assert tck.latest_checkpoint(str(tmp_path / "missing")) is None
    np.savez(str(tmp_path / "junk.npz"), meta_magic=np.array("nope"))
    with pytest.raises(ValueError, match="not a hpa2 checkpoint"):
        tck.load_state(str(tmp_path / "junk.npz"), device="cpu")
    z = _npz(tmp_path / "ckpt_1.npz")
    z["meta_version"] = np.array(3)
    np.savez(str(tmp_path / "new.npz"), **z)
    with pytest.raises(ValueError, match="newer"):
        tck.load_state(str(tmp_path / "new.npz"), device="cpu")
    z = _npz(tmp_path / "ckpt_1.npz")
    del z["f_pc"]
    np.savez(str(tmp_path / "nopc.npz"), **z)
    with pytest.raises(ValueError, match="missing field pc"):
        tck.load_state(str(tmp_path / "nopc.npz"), device="cpu")


def test_v2_counters_and_backfill_match_jax(tmp_path):
    """Schema v2 carries the recovery counters (zero-defaulted); a v1
    file, without ``meta_version``, the recovery metadata and the
    telemetry counters added later, loads in both packages alike."""
    st = _two(tmp_path)
    p2 = str(tmp_path / "v2.npz")
    tck.save_state(p2, st, TCFG, extra_meta={"recovery": {"migrations": 3}})
    _, _, meta = tck.load_state(p2, with_meta=True, device="cpu")
    assert meta == jck.load_state(p2, with_meta=True)[2]
    assert meta["recovery"] == {"migrations": 3, "evacuations": 0,
                                "shed_jobs": 0, "retries": 0}
    z = _npz(p2)
    del z["meta_version"]
    z["meta_extra"] = np.array(json.dumps({"batch": 3}))
    for name in tck._ZERO_BACKFILL:
        del z[f"f_{name}"]
    p1 = str(tmp_path / "v1.npz")
    np.savez(p1, **z)
    got, _, tmeta = tck.load_state(p1, with_meta=True, device="cpu")
    want, _, jmeta = jck.load_state(p1, with_meta=True)
    assert tmeta == jmeta
    assert tmeta["recovery"] == dict.fromkeys(tck.RECOVERY_COUNTERS, 0)
    assert state_diff(want, got, batched=True) == []
    assert tck._ZERO_BACKFILL == jck._ZERO_BACKFILL
    assert tck.RECOVERY_COUNTERS == jck.RECOVERY_COUNTERS


# -- the bench command ------------------------------------------------------

BENCH = ["bench", "--backend", "jax", "--nodes", "4", "--batch", "2",
         "--instrs", "16", "--robust", "--checkpoint-every", "10",
         "--device", "cpu"]


def test_cli_bench_checkpoint_completes_and_cleans(tmp_path, capsys):
    """The checkpointed bench retires every instruction, clears its
    directory, and a rerun starts afresh; its counts equal the JAX
    CLI's."""
    from hpa2_tpu.cli import main as jmain

    ckdir = str(tmp_path / "ck")
    assert cli.main(BENCH + ["--checkpoint-dir", ckdir]) == 0
    assert tck.latest_checkpoint(ckdir) is None
    assert cli.main(BENCH + ["--checkpoint-dir", ckdir]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jmain(BENCH[:-2] + ["--checkpoint-dir", str(tmp_path / "j")]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["instrs"] == want["instrs"] == 2 * 4 * 16
    assert got["resumed_instrs"] == want["resumed_instrs"] == 0


def test_cli_bench_resumes_a_jax_checkpoint(tmp_path, capsys):
    """A mid-run checkpoint written by the JAX package is picked up
    (matching config and workload); only the work after it counts."""
    cfg = jconfig.SystemConfig(num_procs=4, semantics=ROBUST)
    st = jinit_batched(cfg, *gen_uniform_random_arrays(cfg, 2, 16, seed=0))
    st = jchunk(cfg, 10)(st)
    ckdir = tmp_path / "ck"
    ckdir.mkdir()
    jck.save_state(str(ckdir / "ckpt_1.npz"), st, cfg,
                   extra_meta={"batch": 2, "instrs": 16,
                               "workload": "uniform", "seed": 0})
    assert cli.main(BENCH + ["--checkpoint-dir", str(ckdir)]) == 0
    cap = capsys.readouterr()
    assert "resumed from" in cap.err
    rec = json.loads(cap.out.strip().splitlines()[-1])
    assert rec["resumed_instrs"] == int(np.sum(np.asarray(st.n_instr))) > 0
    assert rec["instrs"] == 2 * 4 * 16 - rec["resumed_instrs"]
    assert tck.latest_checkpoint(str(ckdir)) is None


def test_cli_bench_refuses_another_runs_checkpoint(tmp_path):
    cfg = jconfig.SystemConfig(num_procs=4, semantics=ROBUST)
    st = jinit_batched(cfg, *gen_uniform_random_arrays(cfg, 2, 16, seed=0))
    ckdir = tmp_path / "ck"
    ckdir.mkdir()
    jck.save_state(str(ckdir / "ckpt_1.npz"), st, cfg,
                   extra_meta={"batch": 2, "instrs": 16,
                               "workload": "uniform", "seed": 0})
    with pytest.raises(SystemExit, match="different config/workload"):
        cli.main(BENCH + ["--seed", "5", "--checkpoint-dir", str(ckdir)])
