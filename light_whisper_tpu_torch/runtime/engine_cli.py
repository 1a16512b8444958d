"""Engine CLI of the port: ``serve`` on the line-delimited JSON protocol.

    python -m light_whisper_tpu_torch.runtime.engine_cli serve --engine qwen3-asr-0.6b [--device cuda|cpu]

``--device`` defaults to ``cuda``; without a GPU that raises rather than
falling back to the CPU. Only an explicit ``--device cpu`` runs on the CPU.
The model path resolves as in the reference (``LIGHT_WHISPER_MODEL_PATH``,
then the Hugging Face cache).
"""

from __future__ import annotations

import argparse

ENGINE_CHOICES = ["qwen3-asr-0.6b", "qwen3-asr-1.7b"]


def cmd_serve(engine: str, device: str) -> None:
    from light_whisper_tpu_torch.runtime.logging_util import setup_rotating_logger
    from light_whisper_tpu_torch.runtime.qwen3_server import Qwen3EngineServer

    server = Qwen3EngineServer(engine=engine, device=device)  # raises without a GPU for cuda
    logger = setup_rotating_logger(__name__, "qwen3_asr_server.log", "Qwen3-ASR server")
    server.log = logger
    server.serve_forever()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="light-whisper-engine-torch")
    sub = parser.add_subparsers(dest="command", required=True)
    serve_p = sub.add_parser("serve")
    serve_p.add_argument("--engine", choices=ENGINE_CHOICES, default=ENGINE_CHOICES[0])
    serve_p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)
    if args.command == "serve":
        cmd_serve(args.engine, args.device)


if __name__ == "__main__":
    main()
