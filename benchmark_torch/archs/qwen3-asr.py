"""Qwen3-ASR: the dense Qwen3 decoder behind the AuT audio tower.

An architecture's module gives what differs between architectures, found by
the ``"arch"`` of a configuration file (:func:`harness.spec.arch`): its
sizes (:func:`shapes`), its decoder's tensors and GGUF metadata, the decoder
half of the plain reference (:func:`decoder_logits`), and the work counts
that the metric readers hold the trace against. The tower, the vocabulary,
the prompt, the drawing of weights and the GGUF writer are shared
(:mod:`harness.artifact`, :mod:`harness.reference`, :mod:`harness.work`).

Decoder: Qwen3 (pre-norm RMSNorm, GQA attention with per-head q/k RMSNorm
and rotary over the whole head, SwiGLU FFN), the logits head tied to the
token embedding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

from harness import artifact, work
from harness.reference import NEG

GGUF_ARCH = "qwen3asr"
LAYER_TENSORS = ("attn_norm", "attn_q", "attn_k", "attn_v", "attn_output", "attn_q_norm", "attn_k_norm", "ffn_norm",
                 "ffn_gate", "ffn_up", "ffn_down")


@dataclasses.dataclass(frozen=True)
class Qwen3Shapes(artifact.Shapes):
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ffn: int
    rms_eps: float
    rope_theta: float
    context: int

    @property
    def qkv_dim(self) -> int:
        return (self.heads + 2 * self.kv_heads) * self.head_dim


def shapes(cfg: Dict) -> Qwen3Shapes:
    return Qwen3Shapes(
        **artifact.shared_sizes(cfg), layers=cfg["num_hidden_layers"], heads=cfg["num_attention_heads"],
        kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"], ffn=cfg["intermediate_size"],
        rms_eps=float(cfg["rms_norm_eps"]), rope_theta=float(cfg["rope_theta"]),
        context=cfg["max_position_embeddings"],
    )


# -- the artifact ----------------------------------------------------------------


def tensor_specs(s: Qwen3Shapes) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """The decoder's tensors, in the artifact's order (:func:`harness.artifact.specs`)."""
    specs = [("token_embd.weight", (s.vocab, s.d), "q8_vocab", 0.05), ("output_norm.weight", (s.d,), "norm", 0.05)]
    q, kv = s.heads * s.head_dim, s.kv_heads * s.head_dim
    for i in range(s.layers):
        p = f"blk.{i}."
        specs += [
            (p + "attn_norm.weight", (s.d,), "norm", 0.05),
            (p + "attn_q.weight", (q, s.d), "q8", s.d ** -0.5),
            (p + "attn_k.weight", (kv, s.d), "q8", s.d ** -0.5),
            (p + "attn_v.weight", (kv, s.d), "q8", s.d ** -0.5),
            (p + "attn_output.weight", (s.d, q), "q8", q ** -0.5),
            (p + "attn_q_norm.weight", (s.head_dim,), "norm", 0.05),
            (p + "attn_k_norm.weight", (s.head_dim,), "norm", 0.05),
            (p + "ffn_norm.weight", (s.d,), "norm", 0.05),
            (p + "ffn_gate.weight", (s.ffn, s.d), "q8", s.d ** -0.5),
            (p + "ffn_up.weight", (s.ffn, s.d), "q8", s.d ** -0.5),
            (p + "ffn_down.weight", (s.d, s.ffn), "q8", s.ffn ** -0.5),
        ]
    return specs


def metadata(s: Qwen3Shapes) -> Dict[str, object]:
    """The GGUF keys of the architecture (the vocabulary's are shared)."""
    a = GGUF_ARCH + "."
    return {
        "general.architecture": GGUF_ARCH, "general.name": "qwen3-asr-benchmark",
        a + "vocab_size": s.vocab, a + "embedding_length": s.d, a + "block_count": s.layers,
        a + "feed_forward_length": s.ffn, a + "attention.head_count": s.heads,
        a + "attention.head_count_kv": s.kv_heads, a + "attention.key_length": s.head_dim,
        a + "attention.layer_norm_rms_epsilon": s.rms_eps, a + "rope.freq_base": s.rope_theta,
        a + "context_length": s.context, a + "tie_word_embeddings": True,
        **artifact.shared_metadata(a, s),
    }


# -- the plain reference's decoder ------------------------------------------------


def _rms(s, x, w):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + s.rms_eps) * w


def _rope(s, x, positions):
    hd = x.shape[-1]
    inv = 1.0 / (s.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd))
    ang = positions.double()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang).repeat(1, 2).float()[:, None], torch.sin(ang).repeat(1, 2).float()[:, None]
    rot = torch.cat([-x[..., hd // 2:], x[..., : hd // 2]], dim=-1)
    return x * cos + rot * sin


def _layer(ref, i, w, x, low):
    s, lin = ref.s, ref.linear
    p = f"blk.{i}."
    R = x.shape[0]
    hd, G = s.head_dim, s.heads // s.kv_heads
    h = _rms(s, x, w[p + "attn_norm.weight"])
    q = lin(h, w[p + "attn_q.weight"], low=low).reshape(R, s.heads, hd)
    k = lin(h, w[p + "attn_k.weight"], low=low).reshape(R, s.kv_heads, hd)
    v = lin(h, w[p + "attn_v.weight"], low=low).reshape(R, s.kv_heads, hd)
    positions = torch.arange(R, device=x.device)
    q = _rope(s, _rms(s, q, w[p + "attn_q_norm.weight"]), positions)
    k = _rope(s, _rms(s, k, w[p + "attn_k_norm.weight"]), positions)
    k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)  # head h reads KV head h // G
    logits = torch.einsum("qhd,khd->hqk", q, k) * hd ** -0.5
    causal = positions[None, :] <= positions[:, None]
    a = torch.einsum("hqk,khd->qhd", torch.softmax(logits.masked_fill(~causal, NEG), -1), v)
    x = x + lin(a.reshape(R, -1), w[p + "attn_output.weight"], low=low)
    h = _rms(s, x, w[p + "ffn_norm.weight"])
    inner = F.silu(lin(h, w[p + "ffn_gate.weight"], low=low)) * lin(h, w[p + "ffn_up.weight"], low=low)
    return x + lin(inner, w[p + "ffn_down.weight"], low=low)


def decoder_logits(ref, prompts) -> Iterator[Dict[str, torch.Tensor]]:
    """Float32 logits ``[rows from prompt.first on, vocab]`` of each
    :class:`harness.reference.Prompt`, by stream, a request at a time: one
    causal pass over the prompt and the served tokens, which is what prefill
    and the cached decode compute. The stream ``ctl`` rounds the activation
    operand of every linear layer and of the head to float8 (``ref.linear``)."""
    s = ref.s
    emb = ref.weights(["token_embd.weight"])["token_embd.weight"]
    hidden: Dict[str, List[torch.Tensor]] = {}
    for prompt in prompts:
        for name, rows in prompt.audio.items():
            x = emb[torch.as_tensor(prompt.ids, device=emb.device)].clone()
            x[prompt.audio_at: prompt.audio_at + rows.shape[0]] = rows
            hidden.setdefault(name, []).append(x)
    for i in range(s.layers):
        w = ref.weights([f"blk.{i}.{n}.weight" for n in LAYER_TENSORS])
        for name, group in hidden.items():
            for j, x in enumerate(group):
                group[j] = _layer(ref, i, w, x, name == "ctl")
    norm = ref.weights(["output_norm.weight"])["output_norm.weight"]
    for j, prompt in enumerate(prompts):
        yield {name: ref.linear(_rms(s, hidden[name][j][prompt.first:], norm), emb, low=name == "ctl")
               for name in hidden}


# -- work counts ---------------------------------------------------------------


def _decoder_row_flops(s: Qwen3Shapes) -> int:
    q = s.heads * s.head_dim
    return 2 * s.layers * (s.d * s.qkv_dim + q * s.d + s.d * 2 * s.ffn + s.ffn * s.d)


def request_flops(s: Qwen3Shapes, samples: int, tokens: int) -> int:
    """Encoder, prefill and ``tokens - 1`` decode steps (the last token is
    never fed back), each row with its causal attention, plus the logits
    head once a token."""
    p = work.prompt_len(s, samples)
    att = 4 * s.layers * s.heads * s.head_dim
    rows = p + max(0, tokens - 1)
    keys = rows * (rows + 1) // 2  # row t sees t + 1 keys
    head = 2 * s.d * s.vocab * tokens
    return work.encoder_flops(s, samples) + rows * _decoder_row_flops(s) + att * keys + head


def gemv_step_bytes(s: Qwen3Shapes) -> Tuple[int, int]:
    """(weight bytes, bytes a row) of one decode forward's Q8 GEMVs: per
    layer qkv, o, gate-up and down, then the logits head. A row reads its
    input in bf16 once a projection and writes its float32 output."""
    q = s.heads * s.head_dim
    mats = [(s.qkv_dim, s.d), (s.d, q), (2 * s.ffn, s.d), (s.d, s.ffn)]
    weights = s.layers * sum(work.q8_bytes(n, k) for n, k in mats) + work.q8_bytes(s.vocab, s.d)
    per_row = s.layers * sum(2 * k + 4 * n for n, k in mats) + 2 * s.d + 4 * s.vocab
    return weights, per_row


def head_bytes(s: Qwen3Shapes) -> Tuple[int, int]:
    """(weight bytes, bytes a row) of the logits head alone."""
    return work.q8_bytes(s.vocab, s.d), 2 * s.d + 4 * s.vocab


def decode_attention_bytes(s: Qwen3Shapes, prompt: int, steps: int) -> int:
    """K and V (bf16) that ``steps`` decode steps read after a prompt of
    ``prompt`` rows: step j attends prompt + j + 1 positions in every layer."""
    positions = steps * (prompt + 1) + steps * (steps - 1) // 2
    return 2 * s.layers * s.kv_heads * s.head_dim * 2 * positions


# -- launch counts (the program's counters and the trace are held to them) --------


def stacked_launches(s: Qwen3Shapes) -> int:
    """Launches of one decoder pass through a stacked Q8 entry (the fused
    one a decode forward, the plain one a prefill): qkv, o, gate-up, down a layer."""
    return 4 * s.layers


def q8_matmul_launches(s: Qwen3Shapes, forwards: int, prefills: int) -> int:
    """Launches of the plain Q8 entry: the tower's a prefill, and the head
    each decode forward and each prefill."""
    return work.encoder_launches(s) * prefills + forwards + prefills


def gemv_launches(s: Qwen3Shapes, forwards: int, prefills: int) -> int:
    """Q8 launches at T <= 8 rows: four a layer and the head each decode
    forward, and the head once a prefill (its first token)."""
    return forwards * (4 * s.layers + 1) + prefills


def decode_attention_launches(s: Qwen3Shapes, forwards: int) -> int:
    """Decode-attention launches: one a layer each decode forward."""
    return s.layers * forwards
