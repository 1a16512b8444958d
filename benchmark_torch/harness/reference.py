"""The plain reference in float32: what the engine should have computed for a
request, written from the architecture with nothing of the program.

Audio → FireRedVAD trim (:mod:`harness.vad_ref`) → Whisper log-mel (128
bins) → AuT encoder → prompt with the audio rows spliced in → the
configuration's decoder (its architecture's ``decoder_logits``, in
``archs/<arch>.py``: causal, one pass over the prompt and the served tokens)
→ logits. Weights are the configuration's, drawn anew from its seed
(:mod:`harness.artifact`) and dequantized exactly (quant × float16 scale).
Float32 throughout, TF32 off for matmuls and convolutions; the work runs
layer by layer over all requests, so one layer's weights are held at a time.

Three rules of the engine are semantics, not precision, and the reference
keeps them: audio is zero-padded to its bucket (0.5 s steps to 16 s, then
powers of two) before the log-mel, which is clamped at the bucket's max;
the encoder works in chunks of ``2 * n_window`` mel frames, attends within
windows of ``n_window_infer`` frames and never to rows past the audio's own
token count; the prompt is the configuration's chat template.

``control=True`` also runs the same pass with the activation operand of
every linear layer (encoder and decoder projections, the logits head)
rounded to float8 e4m3 with a scale a row, the weights as they are: the
float8 GEMM that an H100 offers one step below the engine's bf16. Nothing
else changes: the residual stream, attention and the norms stay float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from harness import artifact
from harness.artifact import Shapes
from harness.vad_ref import Vad
from harness.work import audio_tokens

RATE, HOP, N_FFT, N_MELS = 16_000, 160, 400, 128
NEG = -1e30
FP8_MAX = 448.0


def bucket(n: int) -> int:
    step, fine = RATE // 2, 16 * RATE
    if n <= fine:
        return max(step, -(-n // step) * step)
    b = fine
    while b < n:
        b *= 2
    return b


def _slaney_mel() -> np.ndarray:
    def to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-12) / 1000.0) / (np.log(6.4) / 27.0),
                        3.0 * f / 200.0)

    def to_hz(m):
        return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), 200.0 * m / 3.0)

    fft = np.linspace(0, RATE / 2, N_FFT // 2 + 1)
    hz = to_hz(np.linspace(to_mel(0.0), to_mel(RATE / 2), N_MELS + 2))
    ramps = hz[None, :] - fft[:, None]
    lower = -ramps[:, :-2] / np.diff(hz)[None, :-1]
    upper = ramps[:, 2:] / np.diff(hz)[None, 1:]
    return np.maximum(0.0, np.minimum(lower, upper)) * (2.0 / (hz[2:] - hz[:-2]))[None, :]


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale a row (its absmax at 448)."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


@dataclasses.dataclass
class Prompt:
    """One request's decoder input, for an architecture's ``decoder_logits``."""

    ids: List[int]  # the chat template's ids with the served tokens but the last
    audio_at: int  # the row where the audio rows go
    audio: Dict[str, torch.Tensor]  # the audio rows by stream: "ref", and "ctl" with the control
    first: int  # the first row whose logits are read (the prompt's last)


class Reference:
    def __init__(self, cfg: Dict, arch, device, control: bool = False):
        self.arch = arch
        self.s: Shapes = arch.shapes(cfg)
        self.specs = artifact.specs(arch, self.s)
        self.seed = cfg["weights_seed"]
        self.device = torch.device(device)
        self.control = control
        self.vad = Vad(self.device)
        self.mel_w = torch.as_tensor(_slaney_mel(), device=self.device)
        n = np.arange(N_FFT)
        self.hann = torch.as_tensor(0.5 - 0.5 * np.cos(2 * np.pi * n / N_FFT), device=self.device)

    # -- helpers -------------------------------------------------------------

    def weights(self, names) -> Dict[str, torch.Tensor]:
        return artifact.named(self.s, self.specs, self.seed, self.device, names)

    def _streams(self, xs):
        """The pass's streams: the reference, and the control beside it."""
        return [("ref", xs)] + ([("ctl", [x.clone() for x in xs])] if self.control else [])

    @staticmethod
    def linear(x, w, b=None, low=False):
        """``x @ w.T + b``; ``low``: the control's float8 activation operand."""
        y = (fp8_rows(x) if low else x) @ w.t()
        return y + b if b is not None else y

    def _ln(self, x, w, b):
        return F.layer_norm(x, (x.shape[-1],), w, b, self.s.ln_eps)

    # -- front end -----------------------------------------------------------

    def log_mel(self, pcm: np.ndarray) -> torch.Tensor:
        """[chunks * chunk_frames, 128] of the trimmed audio, as the encoder takes it."""
        padded = np.zeros(bucket(len(pcm)), np.float64)
        padded[: len(pcm)] = pcm.astype(np.float64) / 32768.0
        frames = len(padded) // HOP
        wave = F.pad(torch.as_tensor(padded, device=self.device)[None, None], (N_FFT // 2, N_FFT // 2),
                     mode="reflect")[0, 0]
        spec = torch.fft.rfft(wave.unfold(0, N_FFT, HOP)[:frames] * self.hann, dim=-1)
        mel = torch.log10(torch.clamp_min((spec.real ** 2 + spec.imag ** 2) @ self.mel_w, 1e-10))
        mel = (torch.maximum(mel, mel.max() - 8.0) + 4.0) / 4.0
        chunk = self.s.chunk_frames
        chunks = max(1, -(-frames // chunk))
        return F.pad(mel.float(), (0, 0, 0, chunks * chunk - frames))

    # -- encoder -------------------------------------------------------------

    def _positions(self, length: int, channels: int) -> torch.Tensor:
        inc = math.log(10_000.0) / (channels // 2 - 1)
        scaled = torch.arange(length, dtype=torch.float64)[:, None] * torch.exp(
            -inc * torch.arange(channels // 2, dtype=torch.float64))[None, :]
        return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1).float().to(self.device)

    def encode(self, mels: Sequence[torch.Tensor], n_audio: Sequence[int]):
        """Audio rows ``[n_audio, output_dim]`` of each request, per stream."""
        s = self.s
        cw = self.weights([f"aenc.conv{i}.{k}" for i in (1, 2, 3) for k in ("weight", "bias")]
                          + ["aenc.conv_out.weight"])
        tpc = s.tokens_per_chunk
        pos = self._positions(tpc, s.a_d)
        xs = []
        for mel in mels:
            x = mel.reshape(-1, s.chunk_frames, s.mels).transpose(1, 2)[:, None]
            for i in (1, 2, 3):
                x = F.gelu(F.conv2d(x, cw[f"aenc.conv{i}.weight"], cw[f"aenc.conv{i}.bias"], stride=2, padding=1))
            c, ch, f, t = x.shape
            xs.append(x.permute(0, 3, 1, 2).reshape(c, t, ch * f))
        streams = {name: [self.linear(x, cw["aenc.conv_out.weight"], low=name == "ctl") + pos for x in group]
                   for name, group in self._streams(xs)}
        cpw, hd = s.chunks_per_window, s.a_d // s.a_heads
        masks = []
        for name in streams:
            for j, x in enumerate(streams[name]):
                c = x.shape[0]
                g = -(-c // cpw)
                x = F.pad(x, (0, 0, 0, 0, 0, g * cpw - c)).reshape(g, cpw * tpc, s.a_d)
                streams[name][j] = x
                if name == "ref":
                    masks.append((torch.arange(g * cpw * tpc, device=self.device) < n_audio[j]).reshape(g, -1))
        for i in range(s.a_layers):
            p = f"aenc.blk.{i}."
            w = self.weights([p + n + k for n in ("attn_norm", "ffn_norm") for k in (".weight", ".bias")]
                             + [p + n + k for n in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_up", "ffn_down")
                                for k in (".weight", ".bias")])
            for name, group in streams.items():
                low = name == "ctl"
                for j, x in enumerate(group):
                    g, W, _ = x.shape
                    h = self._ln(x, w[p + "attn_norm.weight"], w[p + "attn_norm.bias"])
                    q, k, v = (self.linear(h, w[p + n + ".weight"], w[p + n + ".bias"], low)
                               .reshape(g, W, s.a_heads, hd) for n in ("attn_q", "attn_k", "attn_v"))
                    logits = torch.einsum("gqhd,gkhd->ghqk", q, k) * hd ** -0.5
                    logits = logits.masked_fill(~masks[j][:, None, None, :], NEG)
                    a = torch.einsum("ghqk,gkhd->gqhd", torch.softmax(logits, -1), v).reshape(g, W, s.a_d)
                    x = x + self.linear(a, w[p + "attn_output.weight"], w[p + "attn_output.bias"], low)
                    h = self._ln(x, w[p + "ffn_norm.weight"], w[p + "ffn_norm.bias"])
                    h = F.gelu(self.linear(h, w[p + "ffn_up.weight"], w[p + "ffn_up.bias"], low))
                    group[j] = x + self.linear(h, w[p + "ffn_down.weight"], w[p + "ffn_down.bias"], low)
        w = self.weights([f"aenc.{n}.{k}" for n in ("ln_post", "proj1", "proj2") for k in ("weight", "bias")])
        out = {}
        for name, group in streams.items():
            low = name == "ctl"
            rows = []
            for j, x in enumerate(group):
                x = self._ln(x.reshape(-1, s.a_d), w["aenc.ln_post.weight"], w["aenc.ln_post.bias"])
                x = F.gelu(self.linear(x, w["aenc.proj1.weight"], w["aenc.proj1.bias"], low))
                rows.append(self.linear(x, w["aenc.proj2.weight"], w["aenc.proj2.bias"], low)[: n_audio[j]])
            out[name] = rows
        return out

    # -- the comparison ------------------------------------------------------

    @torch.no_grad()
    def run(self, items: Sequence[Dict]) -> List[Dict]:
        """``items``: ``{"pcm": int16 utterance, "tokens": served ids}``. Each
        result: the trim (``samples``, ``segments``), and for every served
        token the gap by which its logit lies below the best one (``gaps``;
        ``control_gaps``: the same for the token the control puts first)."""
        matmul_tf32, conv_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return self._run(items)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul_tf32, conv_tf32

    def _run(self, items):
        results, live = [], []
        for item in items:
            trimmed, segments = self.vad.trim(item["pcm"])
            results.append({"samples": len(trimmed), "segments": segments})
            if segments and item["tokens"]:
                live.append((len(results) - 1, trimmed, list(item["tokens"])))

        def gaps(j, rows):
            served = torch.as_tensor(live[j][2], device=self.device)
            best = rows["ref"].max(dim=-1).values
            out = {"gaps": (best - rows["ref"].gather(1, served[:, None])[:, 0]).tolist()}
            if self.control:
                picks = rows["ctl"].argmax(dim=-1)
                out["control_gaps"] = (best - rows["ref"].gather(1, picks[:, None])[:, 0]).tolist()
            return out

        for (index, _t, _tok), found in zip(live, self.score([(t, tok) for _i, t, tok in live], reduce=gaps)):
            results[index].update(found)
        return results

    @torch.no_grad()
    def score(self, requests, reduce=None):
        """Logits ``[len(tokens), vocab]`` before each served token of every
        ``(trimmed pcm, tokens)``, as ``{"ref": ..., "ctl": ...}`` a request,
        or what ``reduce(index, logits)`` makes of them, one request at a time."""
        s = self.s
        live = [(pcm, list(tokens)) for pcm, tokens in requests]
        if not live:
            return []
        n_audio = [audio_tokens(s, len(t)) for t, _tok in live]
        audio = self.encode([self.log_mel(t) for t, _tok in live], n_audio)
        prompts = [Prompt(ids=artifact.prompt_ids(s, n) + tokens[:-1], audio_at=artifact.PREFIX_LEN,
                          audio={name: rows[j] for name, rows in audio.items()},
                          first=artifact.PREFIX_LEN + n + artifact.SUFFIX_LEN - 1)
                   for j, ((_t, tokens), n) in enumerate(zip(live, n_audio))]
        return [reduce(j, rows) if reduce is not None else rows
                for j, rows in enumerate(self.arch.decoder_logits(self, prompts))]
