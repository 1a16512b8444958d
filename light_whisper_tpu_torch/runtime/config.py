"""The engine configuration's readers (``engine.json``).

The port's copy of the readers of ``light_whisper_tpu/runtime/config.py``
that the engine CLI calls to pick an engine when ``--engine`` is not given:

- ``engine.json`` lives in the data dir; reads are tolerant (a missing file,
  invalid JSON or a non-object all read as an empty config);
- the active engine is whitelist-validated with ``qwen3-asr-0.6b`` as the
  fallback, so a corrupt or hand-edited config never selects an unknown
  engine.

Nothing in the port writes ``engine.json``: the app's shell owns the file.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict

VALID_ENGINES = ("qwen3-asr-0.6b", "qwen3-asr-1.7b", "glm-asr", "alibaba-asr")
DEFAULT_ENGINE = "qwen3-asr-0.6b"


def data_dir() -> str:
    return os.environ.get(
        "LIGHT_WHISPER_DATA_DIR", os.path.join(tempfile.gettempdir(), "light-whisper")
    )


def engine_config_path() -> str:
    return os.path.join(data_dir(), "engine.json")


def read_engine_json() -> Dict[str, Any]:
    try:
        with open(engine_config_path(), "r", encoding="utf-8") as f:
            value = json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}
    return value if isinstance(value, dict) else {}


def read_engine_config() -> str:
    engine = read_engine_json().get("engine")
    return engine if engine in VALID_ENGINES else DEFAULT_ENGINE
