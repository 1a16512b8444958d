"""PyTorch/CUDA port of the light-whisper engine.

The JAX package ``light_whisper_tpu`` is the reference; this package mirrors
its layout, imports ``torch`` and never ``jax``, and imports nothing of the
reference package: where the port needs a module of it that does not run JAX
(GGUF reader, tokenizer, prompt, config, PCM, wire server, scheduler,
long-form windowing, VAD segmenter, hot words), it keeps its own copy under
the same name and place.
"""

__version__ = "0.1.0"
