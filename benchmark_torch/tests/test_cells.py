"""A cell added as files and entries runs end to end (CPU rehearsal), and a
run that finds no card, or no program, fails without a result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, REPO, run_env


def run(root, *args, env=None, timeout=600):
    return subprocess.run([sys.executable, "benchmark_torch/run.py", *args], cwd=root, env=env or run_env(),
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("traffic", ["dictation", "streams8"])
def test_a_cell_added_as_files_runs_end_to_end(workspace, traffic):
    out = run(workspace, "--workload", f"tiny.{traffic}", "--seed", str(2**32 + 9), "--seconds", "3", "--trace", "0",
              "--rehearse")
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["rehearsal"] is True and "metrics" not in result and "device" not in result
    assert result["correct"] is True, out.stderr[-3000:]
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check mean_logit_gap")


def test_no_card_no_result(workspace):
    out = run(workspace, "--workload", "tiny.dictation", "--seed", "1", "--seconds", "3", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_unknown_cell_no_result(workspace):
    out = run(workspace, "--workload", "tiny.nothing", "--seed", "1", "--seconds", "3", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark_torch", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for extra in ([], ["--rehearse"]):
        out = run(tmp_path, "--workload", "qwen3-asr-0.6b.dictation", "--seed", "1", "--seconds", "3", "--trace",
                  "0", *extra, env=env)
        assert out.returncode != 0 and out.stdout.strip() == "", out.stderr[-2000:]


def test_a_run_refuses_jax_in_its_process(monkeypatch):
    import types

    from harness import runner

    runner.require_clean_imports()
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(runner.RunError):
        runner.require_clean_imports()
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    with pytest.raises(runner.RunError):
        runner.require_clean_imports()
    monkeypatch.delitem(sys.modules, "flax")
    monkeypatch.setitem(sys.modules, "light_whisper_tpu.models", types.ModuleType("light_whisper_tpu.models"))
    with pytest.raises(runner.RunError):
        runner.require_clean_imports()
