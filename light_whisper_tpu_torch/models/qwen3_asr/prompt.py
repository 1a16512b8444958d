"""ASR prompt resolution from GGUF ``tokenizer.chat_template`` metadata.

The port's copy of ``light_whisper_tpu/models/qwen3_asr/prompt.py``.

Real llama.cpp-family artifacts (the ``handy-computer/Qwen3-ASR-*-gguf``
files the reference serves — ``hf_cache_utils.py:11-26``, consumed at
``qwen3_asr_server.py:318-321``) store a **Jinja** chat template under
``tokenizer.chat_template``; transcribe.cpp renders the same metadata
inside its C++ runtime. This repo's own converted artifacts store an
explicit ``{audio}``-placeholder string (``convert_hf.py``). Both must
load — refusing a Jinja template would reject every real artifact:

- ``{audio}`` templates split literally (the explicit convention);
- Jinja templates render through the same sandboxed environment that
  transformers' ``apply_chat_template`` uses
  (``transformers/utils/chat_template_utils.py``), driven by the
  Qwen3-ASR conversation shape (system context turn + user audio turn,
  ``add_generation_prompt=True``), then split once on the artifact's own
  audio token string (``vocab[audio_token_id]``);
- anything else — missing template, unrenderable Jinja, or a render that
  never places the audio token — falls back to the built-in Qwen
  convention rather than refusing to serve (the engine must come up; the
  reference's shell kills engines that fail init, ``funasr_service.rs``).

The resulting (prefix_ids, suffix_ids) pair is the serving contract:
``prompt = prefix_ids + [audio_token_id] * n_audio + suffix_ids``.
Token-for-token parity of this sequence against transformers'
``apply_chat_template`` + Qwen3-Omni processor expansion is pinned by
``tests/test_prompt_render_parity.py``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

DEFAULT_TEMPLATE = "<|im_start|>user\n{audio}<|im_end|>\n<|im_start|>assistant\n"


def asr_messages(context: str = "") -> list:
    """The Qwen3-ASR conversation shape: a system turn carrying optional
    biasing context (empty by default — the public Qwen3-ASR examples send
    an empty system text) and a user turn containing exactly one audio
    item. Content is the list-of-parts convention every Qwen multimodal
    template iterates over."""
    return [
        {"role": "system", "content": [{"type": "text", "text": context}]},
        {
            "role": "user",
            "content": [{"type": "audio", "audio": "", "audio_url": ""}],
        },
    ]


def is_jinja(template: str) -> bool:
    """``{audio}`` templates are literal; Jinja shows statement/expression
    delimiters. Checked only after the ``{audio}`` fast path, so a literal
    template containing braces elsewhere cannot be misclassified."""
    return "{%" in template or "{{" in template


def render_chat_template(template: str, context: str = "") -> str:
    """Render a Jinja chat template exactly as transformers does.

    Mirrors ``transformers.utils.chat_template_utils._compile_jinja_template``:
    ``ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True,
    extensions=[loopcontrols])`` with ``raise_exception``/``strftime_now``
    globals and a ``tojson`` filter. Rendering divergence from transformers
    is a fidelity bug, so the environment must match theirs knob-for-knob.
    """
    import json

    import jinja2
    import jinja2.ext
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def strftime_now(fmt):
        from datetime import datetime

        return datetime.now().strftime(fmt)

    def tojson(obj, sort_keys=False, indent=None, separators=None, ensure_ascii=False):
        return json.dumps(
            obj,
            sort_keys=sort_keys,
            indent=indent,
            separators=separators,
            ensure_ascii=ensure_ascii,
        )

    env = ImmutableSandboxedEnvironment(
        trim_blocks=True,
        lstrip_blocks=True,
        extensions=[jinja2.ext.loopcontrols],
    )
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = strftime_now
    return env.from_string(template).render(
        messages=asr_messages(context),
        add_generation_prompt=True,
        tools=None,
    )


def resolve_prompt_text(
    template: Optional[str], audio_token: Optional[str], context: str = ""
) -> Tuple[str, str]:
    """(prefix_text, suffix_text) around the audio span.

    ``audio_token`` is the vocab string for the artifact's audio_token_id —
    the split is keyed on the artifact's own convention, never a hardcoded
    literal, so any Qwen-family template that places its audio token once
    resolves correctly.
    """
    template = template or DEFAULT_TEMPLATE
    if "{audio}" in template:
        prefix, suffix = template.split("{audio}", 1)
        return prefix, suffix
    if is_jinja(template) and audio_token:
        try:
            rendered = render_chat_template(template, context)
        except Exception:
            rendered = ""
        if rendered.count(audio_token) >= 1:
            # Split at the first occurrence; the processor's expansion
            # (processing_qwen3_omni_moe.py:255) also replaces the first.
            prefix, suffix = rendered.split(audio_token, 1)
            return prefix, suffix
    # Fallback: the built-in convention. Serving stays up; the template is
    # surfaced via metadata/stats rather than failing initialize().
    prefix, suffix = DEFAULT_TEMPLATE.split("{audio}", 1)
    return prefix, suffix


def resolve_prompt_ids(
    template: Optional[str],
    tokenizer,
    audio_token_id: int,
    context: str = "",
) -> Tuple[List[int], List[int]]:
    """Encode the resolved prefix/suffix with the artifact's tokenizer."""
    audio_token = None
    if 0 <= audio_token_id < len(tokenizer.tokens):
        audio_token = tokenizer.tokens[audio_token_id]
    prefix_text, suffix_text = resolve_prompt_text(template, audio_token, context)
    return tokenizer.encode(prefix_text), tokenizer.encode(suffix_text)
