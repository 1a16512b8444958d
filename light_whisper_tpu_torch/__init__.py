"""PyTorch/CUDA port of the light-whisper engine.

The JAX package ``light_whisper_tpu`` is the reference; this package mirrors
its layout, imports ``torch`` and never ``jax``. JAX-free modules of the
reference (GGUF reader, tokenizer, prompt, config, PCM, wire server, VAD
segmenter) are imported from it rather than copied.
"""

__version__ = "0.1.0"
