"""The Hopper CTA budget (``hpa2_tpu_torch/analysis/vmem.py``) on the
CPU: its largest lane block is the one the card takes at each node
bound (``kernels.MAX_LANE_BLOCK``, measured by
``scripts/block_limits.py``), its shared memory is the kernel's own
``Shared<MAXN>::bytes`` (through the g++ host build of ``cycle.cuh``
that ``test_torch_kernel_host.py`` makes), and its geometry is the
launch's (``kernels.geometry_args``).  The card's own figure
(``CudaKernel.occupancy``) is held against the model in
``chip_smoke.py``'s ``[build]`` rows and in ``test_torch_card.py``."""

import subprocess
import sys

import pytest

from hpa2_tpu_torch.analysis import vmem
from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.ops import kernels
from test_torch_kernel_host import host_lib  # noqa: F401 (fixture)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _cfg(n, **kw):
    return SystemConfig(num_procs=n, msg_buffer_size=16, max_instr_num=0,
                        **kw)


@pytest.mark.parametrize("n", [2, 4, 8, 9, 16, 21, 22, 33, 64])
def test_max_fitting_block_is_the_cards(n):
    cfg = _cfg(n)
    assert vmem.max_fitting_block(cfg) == \
        kernels.MAX_LANE_BLOCK[kernels.node_bound(cfg)]
    # one more round does not fit
    top = vmem.vmem_budget(cfg, vmem.max_fitting_block(cfg), 32)
    assert top.fits and top.cl == kernels.MAX_CLUSTER
    bound = kernels.node_bound(cfg)
    assert vmem.shared_bytes(bound, top.group, top.rounds + 1) > \
        vmem.SMEM_CAP_BYTES


@pytest.mark.parametrize("bound", [8, 21, 64])
def test_shared_bytes_equals_the_kernels(host_lib, bound):  # noqa: F811
    for group in (1, 3, 32, 64, 200, 256):
        if group * kernels.threads_per_system(_cfg(bound)) > kernels.MAX_CTA:
            continue
        for rounds in (1, 2, 5, 18, 20):
            assert vmem.shared_bytes(bound, group, rounds) == \
                host_lib.hpa2_shared_bytes(bound, group, rounds), \
                (bound, group, rounds)


@pytest.mark.parametrize("n", [4, 12, 64])
def test_geometry_is_the_launchs(n):
    cfg = _cfg(n)
    threads = kernels.threads_per_system(cfg)
    for block in (1, 7, 64, 512, 1000, 1024, 2048, 9216, 20480):
        for max_group in (None, 1, 3):
            want = kernels.launch_geometry(block, threads, max_group)
            bud = vmem.vmem_budget(cfg, block, 32, max_group=max_group)
            assert (bud.cl, bud.per_cta, bud.rounds, bud.group) == want
            args = kernels.geometry_args(cfg, lanes=block, block=block,
                                         max_group=max_group)
            assert (args.cl, args.per_cta, args.rounds, args.group) == want


def test_budget_fits_the_main_paths_and_packing_saves_bytes():
    cfg = _cfg(8)
    for block in (512, 1024, kernels.MAX_LANE_BLOCK[8]):
        bud = vmem.vmem_budget(cfg, block, 32)
        assert bud.fits and bud.headroom_bytes >= 0 and bud.ctas_per_sm >= 1
    plain = vmem.vmem_budget(cfg, 512, 32)
    packed = vmem.vmem_budget(cfg, 512, 32, packed=True)
    assert packed.smem_bytes == plain.smem_bytes
    assert packed.plane_bytes < plain.plane_bytes
    assert vmem.state_plane_bytes(cfg, packed=True) < \
        vmem.state_plane_bytes(cfg)
    assert not vmem.vmem_budget(cfg, kernels.MAX_LANE_BLOCK[8] + 4096,
                                32).fits


@pytest.mark.parametrize("n", [4, 8, 33])
def test_plane_bytes_equal_the_jax_models(n):
    """The device bytes of the planes are the JAX model's per-lane
    plane bytes: the layouts are one."""
    from hpa2_tpu.analysis import vmem as jx_vmem
    from hpa2_tpu.config import SystemConfig as JxConfig

    jcfg = JxConfig(num_procs=n, msg_buffer_size=16, max_instr_num=0)
    for packed in (False, True):
        assert vmem.state_plane_bytes(_cfg(n), packed=packed) == \
            jx_vmem.state_plane_bytes(jcfg, packed=packed)
        assert vmem._plane_lane_bytes(_cfg(n), False, packed) == \
            jx_vmem._plane_lane_bytes(jcfg, False, packed)


def test_node_shards_name_item_4():
    """One rank of the node-sharded fast path (ported in ROADMAP queue 1
    item 4b): the per-shard rows of JAX ``vmem.py:144-175`` (node-leading
    planes split, ``scalars``/``msg_counts`` whole), one card's plane
    bytes, and no CTA (the cycle there is tensor code); ``analysis vmem
    --node-shards`` prints the rank's table."""
    from hpa2_tpu.analysis import vmem as jvmem
    from hpa2_tpu.config import SystemConfig as JSystemConfig

    for n, d in ((8, 2), (64, 4), (22, 2)):
        bud = vmem.vmem_budget(_cfg(n), 512, 32, node_shards=d)
        jb = jvmem.vmem_budget(JSystemConfig(
            num_procs=n, msg_buffer_size=16, max_instr_num=0), 512, 32,
            node_shards=d)
        assert bud.rows == jb.rows and bud.lane_bytes == jb.lane_bytes
        assert (bud.carried_rows, bud.snap_rows, bud.trace_rows) == (
            jb.carried_rows, jb.snap_rows, jb.trace_rows)
        assert bud.smem_bytes == bud.group == bud.ctas_per_sm == 0
        assert bud.plane_bytes == bud.total_lane_bytes * 512
    with pytest.raises(ValueError, match="must divide"):
        vmem.vmem_budget(_cfg(8), 512, 32, node_shards=3)
    with pytest.raises(ValueError, match="no CTA"):
        vmem.max_fitting_block(_cfg(8), node_shards=2)
    proc = subprocess.run(
        [sys.executable, "-m", "hpa2_tpu_torch.analysis", "vmem",
         "--node-shards", "2"], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "one rank of 2" in proc.stdout and "4 nodes a rank" in proc.stdout


def test_vmem_cli_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "hpa2_tpu_torch.analysis", "vmem",
         "--device", "cpu", "--blocks", "512,1024,20480"],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "223240" in proc.stdout and "max fitting block: 20480" in \
        proc.stdout
