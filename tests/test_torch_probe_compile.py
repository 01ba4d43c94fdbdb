"""``hpa2_tpu_torch/scripts/probe_compile.py`` on the CPU: it needs the
card (and raises without one), its model figures are those of ``python
-m hpa2_tpu_torch.analysis vmem`` at the same shapes, and it names the
instantiation whose ptxas lines it reads as the mangled names do."""

import contextlib
import io

import pytest
import torch

from hpa2_tpu_torch.analysis.__main__ import main as analysis_main
from hpa2_tpu_torch.analysis.ir import ptxas_census
from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.scripts import probe_compile
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: (nodes, block, window, packed): the session's three probes, a split
#: 64-node block, a packed one and the card's largest 8-node block
SHAPES = [(8, 512, 32, False), (8, 1024, 8, False), (8, 2048, 8, False),
          (64, 512, 16, False), (12, 1024, 16, True),
          (8, kernels.MAX_LANE_BLOCK[8], 32, False)]


def vmem_row(nodes, block, window, packed):
    """The ``analysis vmem --device cpu`` row of ``block``, by column."""
    argv = ["vmem", "--device", "cpu", "--blocks", str(block), "--window",
            str(window), "--procs", str(nodes)] + (["--packed"] * packed)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert analysis_main(argv) == 0
    head, row = [line.split() for line in buf.getvalue().splitlines()[1:3]]
    assert head[:3] == ["block", "CTAs", "group"]
    return dict(zip(("block", "cl", "group", "rounds", "threads", "smem",
                     "headroom", "ctas_per_sm"), map(int, row[:8])),
                fits=row[-1] == "yes")


@pytest.mark.parametrize("nodes,block,window,packed", SHAPES)
def test_model_figures_equal_analysis_vmem(nodes, block, window, packed):
    cfg = SystemConfig(num_procs=nodes, msg_buffer_size=16)
    want = vmem_row(nodes, block, window, packed)
    for stream in (True, False):
        got = probe_compile.model_figures(cfg, block, window, stream=stream,
                                          packed=packed)
        assert (got["model_cl"], got["model_group"], got["model_rounds"],
                got["model_threads"], got["model_smem_bytes"],
                got["model_headroom_bytes"], got["model_ctas_per_sm"],
                got["model_fits"]) == (
            want["cl"], want["group"], want["rounds"], want["threads"],
            want["smem"], want["headroom"], want["ctas_per_sm"],
            want["fits"])


def test_instantiation_names_match_the_ptxas_log():
    """The census entries :func:`probe_compile.instantiation` selects
    from a log of the shape nvcc writes: one of the six a library."""
    log = "\n".join(
        f"ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__"
        f"3d3b783a_13_stream_run_cu_5528364117stream_run_kernelILi{b}ELb{p}"
        f"EEEvN4hpa24ArgsE' for 'sm_90a'\n"
        f"ptxas info    : Function properties for x\n"
        f"    {b} bytes stack frame, {p} bytes spill stores, 0 bytes spill "
        f"loads\nptxas info    : Used {100 + b} registers"
        for b in (8, 21, 64) for p in (0, 1))
    for nodes, bound in ((8, 8), (12, 21), (40, 64)):
        cfg = SystemConfig(num_procs=nodes, msg_buffer_size=16)
        for packed in (False, True):
            name = probe_compile.instantiation(kernels.STREAM_RUN, cfg,
                                               packed)
            hits = [e for e in ptxas_census(log) if name in e["name"]]
            assert len(hits) == 1
            assert (hits[0]["registers"], hits[0]["stack"],
                    hits[0]["spill_stores"]) == (100 + bound, bound,
                                                 int(packed))


def test_probe_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this refusal needs none")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probe_compile.main(["--block", "512", "--window", "32"])
