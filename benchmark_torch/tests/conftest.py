"""CPU tests of the benchmark harness: ``python -m pytest benchmark_torch/tests -q``.

They import the harness from ``benchmark_torch/`` and the port from the
repository root; nothing here imports JAX. ``workspace`` builds a checkout
of its own: a copy of ``benchmark_torch/``, a tiny configuration added as a
file with its limits, and a ``BENCHMARK.json`` that names its cells.
"""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(0, REPO)

from harness import spec  # noqa: E402

QWEN3_ASR = spec.arch("qwen3-asr", REPO)

TINY = {
    "vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128, "audio_token_id": 511,
    "bos_token_id": 509, "eos_token_id": 510, "pad_token_id": 508, "weights_seed": 3,
}
TINY_AUDIO = {"d_model": 64, "encoder_layers": 2, "encoder_attention_heads": 2, "encoder_ffn_dim": 128,
              "downsample_hidden_size": 32, "output_dim": 64}
# mean_logit_gap: between the program's largest reading (3.5e-5) and the control's smallest (1.7e-4) over a
# dozen seeds of 3 s rehearsals (calibrate.py --rehearse) of tiny.dictation and tiny.streams8
TINY_LIMITS = {"reference_requests": 24, "mean_logit_gap": 0.00012}


def tiny_config() -> dict:
    with open(os.path.join(BENCH, "configs", "qwen3-asr-0.6b.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY)
    cfg["audio"] = {**cfg["audio"], **TINY_AUDIO}
    return cfg


@pytest.fixture
def workspace(tmp_path):
    """A checkout holding ``benchmark_torch/`` plus the cells ``tiny.dictation``
    and ``tiny.streams8``, added as files and entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark_torch", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "benchmark_torch" / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    (root / "benchmark_torch" / "limits" / "tiny.json").write_text(json.dumps(TINY_LIMITS))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny", "source": "tiny test model", "file": "benchmark_torch/configs/tiny.json",
                             "reduced": [], "why": "CPU rehearsal"})
    bench["workloads"] += [{"name": f"tiny.{t}", "config": "tiny", "traffic": t, "chips": 1, "why": "CPU rehearsal"}
                           for t in ("dictation", "streams8")]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("LIGHT_WHISPER_FORCE_CPU", None)
    return env
