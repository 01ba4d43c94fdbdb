"""The port's shell gates, ``hpa2_tpu_torch/scripts/run_static.sh`` and
``run_slow.sh``: every command they run names the port's package, never
the JAX package nor ``make``; both parse; and the static gate runs to
``STATIC_OK`` on the CPU."""

import pathlib
import re
import shutil
import subprocess

import pytest

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCRIPTS = pathlib.Path(__file__).resolve().parent.parent / "hpa2_tpu_torch" \
    / "scripts"
GATES = ("run_static.sh", "run_slow.sh")


def commands(name):
    """The script's lines that are not comments, echoes or blank, with
    continuation lines joined."""
    text = (SCRIPTS / name).read_text().replace("\\\n", " ")
    return [line.strip() for line in text.splitlines()
            if line.strip() and not line.strip().startswith(("#", "echo"))]


@pytest.mark.parametrize("name", GATES)
def test_gate_commands_name_the_port(name):
    cmds = commands(name)
    assert cmds[0].startswith("set ")
    pythons = [c for c in cmds if "python" in c]
    assert pythons
    for c in cmds:
        assert "hpa2_tpu." not in c and "hpa2_tpu " not in c, c
        assert not re.search(r"\bmake\b", c), c
        assert "native/build" not in c, c
    for c in pythons:
        mods = re.findall(r"python -m (\S+)", c)
        imports = re.findall(r"from (\S+) import", c)
        assert mods or imports, c
        for m in mods + imports:
            assert m == "pytest" or m.startswith("hpa2_tpu_torch"), c
    if name == "run_slow.sh":
        assert any("tests/test_torch_*.py" in c and "-m slow" in c
                   for c in pythons)


@pytest.mark.parametrize("name", GATES)
def test_gate_parses(name):
    bash = shutil.which("bash")
    if bash is None:
        pytest.skip("bash is not installed")
    subprocess.run([bash, "-n", str(SCRIPTS / name)], check=True)


def test_static_gate_passes():
    bash = shutil.which("bash")
    if bash is None:
        pytest.skip("bash is not installed")
    proc = subprocess.run([bash, str(SCRIPTS / "run_static.sh")],
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = proc.stdout.splitlines()
    assert out[-1] == "STATIC_OK"
    # the data-sharded point and the three node-sharded points (the
    # fast path's and the general engine's two) run on the CPU
    assert "12 contract(s) clean, 0 drifted, 0 skipped" in proc.stdout
    # the sanitized engine ran, or the toolchain lacks the sanitizers
    assert any('"instructions":1200' in x or "unavailable; skipped" in x
               for x in out)
