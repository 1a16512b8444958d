"""``chip_smoke.py`` refuses to report a result without a GPU, and outside a
checkout of the repository; its narrow-model token gate holds the card to
the CPU within the 1e-3 tie band."""

import importlib.util
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: run chip_smoke.py itself")


@pytest.mark.usefixtures("_no_gpu")
@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_fails_without_result(tmp_path, where):
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, script], capture_output=True, text=True, cwd=os.path.dirname(script),
                          env=env, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_gate", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # imports nothing but the standard library at module level
    return module


def test_narrow_gate_passes_equal_tokens():
    assert _smoke().narrow_verdict([5, 6, 7, 8], [5, 6, 7, 8], []) is None


def test_narrow_gate_passes_a_tie_flip_followed_by_other_tokens():
    smoke = _smoke()
    assert smoke.TIE_BAND == 1e-3
    assert smoke.narrow_verdict([5, 6, 7, 8], [5, 6, 9, 2], [(2, 4e-4)]) is None


def test_narrow_gate_fails_a_flip_outside_the_tie_band():
    verdict = _smoke().narrow_verdict([5, 6, 7, 8], [5, 6, 9, 2], [(2, 5e-3)])
    assert verdict is not None and "tie band" in verdict


def test_narrow_gate_fails_tokens_that_differ_before_any_flip():
    smoke = _smoke()
    assert "no argmax flip" in smoke.narrow_verdict([5, 6, 7, 8], [5, 1, 7, 8], [])
    assert "before the first flip" in smoke.narrow_verdict([5, 6, 7, 8], [5, 1, 9, 2], [(2, 4e-4)])
