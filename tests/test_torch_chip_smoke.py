"""``chip_smoke.py`` refuses to report a result without a GPU, and outside a
checkout of the repository."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: run chip_smoke.py itself")


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
