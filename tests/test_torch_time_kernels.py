"""``hpa2_tpu_torch/scripts/time_kernels.py``'s argument handling on the
CPU (the timings themselves need the card): the defaults, ``--wide``,
``--tree`` resolved and checked, ``--reps`` at least one, and ``main``
refusing (exit 2, no JSON line) without CUDA."""

import sys
from pathlib import Path

import pytest

from hpa2_tpu_torch.scripts import time_kernels

REPO = Path(time_kernels.__file__).resolve().parents[2]


def test_defaults_time_this_tree():
    args = time_kernels.parse_args([])
    assert args.tree == str(REPO) and args.reps == 2 and not args.wide
    args = time_kernels.parse_args(["--wide", "--reps", "3", "--tree",
                                    str(REPO / "hpa2_tpu_torch" / "..")])
    assert args.wide and args.reps == 3 and args.tree == str(REPO)


@pytest.mark.parametrize("argv", (["--reps", "0"], ["--tree", "/nonexistent"],
                                  ["--tree", str(REPO / "tests")],
                                  ["--no-such-flag"]))
def test_bad_arguments_exit_2(argv, capsys):
    with pytest.raises(SystemExit) as e:
        time_kernels.parse_args(argv)
    assert e.value.code == 2
    assert "usage" in capsys.readouterr().err


def test_wide_paths_are_the_smokes_wide_runs():
    """``--wide`` times chip_smoke.py's wide runs' geometries."""
    assert [p[1:] for p in time_kernels.WIDE_PATHS] == [(4096, 8, 2),
                                                        (256, 256, 4)]
    assert time_kernels.WIDE_KEEP_AT < time_kernels.WIDE_CALL


def test_main_refuses_without_cuda(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert time_kernels.main(["--wide"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA is not available" in out.err
