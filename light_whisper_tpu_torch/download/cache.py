"""HuggingFace cache layout: the model registry and exact-file resolution.

The port's copy of the parts of ``light_whisper_tpu/download/cache.py`` that
the engine server calls (``QWEN3_ASR_MODELS``, ``find_snapshot_file``), with
the reference app's semantics (``hf_cache_utils.py:11-204``):

- cache root priority: ``HF_HUB_CACHE`` > ``HF_HOME``/hub > ``~/.cache``;
- exact-file resolution honors ``refs/main`` first, skips files under 1 MB
  and, where a snapshot carries a completion manifest
  (``.light_whisper_complete.json``), files whose size it does not list.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

QWEN3_ASR_MODELS: Dict[str, Dict] = {
    "qwen3-asr-0.6b": {
        "repo_id": "handy-computer/Qwen3-ASR-0.6B-gguf",
        "filename": "Qwen3-ASR-0.6B-Q8_0.gguf",
        "revision": "e4e16599b900eb0cb36e524514756bb92eb092b7",
        "size": 850_423_456,
        "sha256": "f081b2d5e23bd669d92cc331d722a8a0681943b8e6f34b48996fd5c319b5acd8",
    },
    "qwen3-asr-1.7b": {
        "repo_id": "handy-computer/Qwen3-ASR-1.7B-gguf",
        "filename": "Qwen3-ASR-1.7B-Q8_0.gguf",
        "revision": "92282af1610a2db19d66f2bef1e260f5deca782d",
        "size": 2_185_030_624,
        "sha256": "9a0d81792dfea2d5f278b8a63deb3ea6e02139ce42c2301f32ea19c4f77526b7",
    },
}

MIN_WEIGHT_SIZE = 1_000_000
MANIFEST_NAME = ".light_whisper_complete.json"


def hf_cache_root() -> str:
    explicit = os.environ.get("HF_HUB_CACHE")
    if explicit:
        return explicit
    home = os.environ.get("HF_HOME")
    if home:
        return os.path.join(home, "hub")
    return os.path.join(os.path.expanduser("~"), ".cache", "huggingface", "hub")


def repo_dir(repo_id: str) -> str:
    return os.path.join(hf_cache_root(), "models--" + repo_id.replace("/", "--"))


def find_snapshot_file(repo_id: str, filename: str) -> Optional[str]:
    base = repo_dir(repo_id)
    snapshots = os.path.join(base, "snapshots")
    if not os.path.isdir(snapshots):
        return None

    ordered = []
    try:
        with open(os.path.join(base, "refs", "main"), "r", encoding="utf-8") as f:
            ordered.append(f.read().strip())
    except OSError:
        pass
    ordered.extend(n for n in os.listdir(snapshots) if n not in ordered)

    rel = filename.replace("/", os.sep)
    for name in ordered:
        snapshot = os.path.join(snapshots, name)
        candidate = os.path.join(snapshot, rel)
        try:
            size = os.path.getsize(candidate)
        except OSError:
            continue
        if size < MIN_WEIGHT_SIZE:
            continue
        manifest_path = os.path.join(snapshot, MANIFEST_NAME)
        try:
            with open(manifest_path, "r", encoding="utf-8") as f:
                manifest = json.load(f)
            entry = next(
                (item for item in manifest.get("files", []) if item.get("path") == filename),
                None,
            )
            if entry is None or entry.get("size") != size:
                continue
        except (OSError, json.JSONDecodeError):
            pass  # legacy caches predate the manifest
        return candidate
    return None
