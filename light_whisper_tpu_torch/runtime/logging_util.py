"""Engine logging: rotating file + stderr mirror.

The port's copy of ``light_whisper_tpu/runtime/logging_util.py``.

Same operational shape as the reference (``server_common.py:64-93``): 5 MB ×
3 rotating file under ``$LIGHT_WHISPER_DATA_DIR/logs`` (temp fallback), plus
a stderr stream the parent process captures — stdout stays reserved for the
JSON protocol.
"""

from __future__ import annotations

import logging
import os
import sys
import tempfile
from logging.handlers import RotatingFileHandler


def log_path(filename: str) -> str:
    if "LIGHT_WHISPER_DATA_DIR" in os.environ:
        log_dir = os.path.join(os.environ["LIGHT_WHISPER_DATA_DIR"], "logs")
    else:
        log_dir = os.path.join(tempfile.gettempdir(), "light_whisper_logs")
    os.makedirs(log_dir, exist_ok=True)
    return os.path.join(log_dir, filename)


def setup_rotating_logger(module_name: str, filename: str, service_name: str) -> logging.Logger:
    path = log_path(filename)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(levelname)s - %(message)s",
        handlers=[
            RotatingFileHandler(path, encoding="utf-8", maxBytes=5 * 1024 * 1024, backupCount=3),
            logging.StreamHandler(sys.stderr),
        ],
    )
    logger = logging.getLogger(module_name)
    logger.info("%s log file: %s", service_name, path)
    return logger
