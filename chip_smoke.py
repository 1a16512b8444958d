#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py                  # every phase (one card)
    python3 chip_smoke.py --kernels-only   # identify, build, kernel-vs-plain checks

Phases, one line each (``phase <name>: ok|FAIL ...``):

1. identify the card (``nvidia-smi`` name and power limit, torch and CUDA versions);
2. build the kernels of ``light_whisper_tpu_torch/csrc`` with ``nvcc``;
3. each kernel against its plain PyTorch version on the card, at Qwen3-ASR
   0.6B shapes (those of the single-pass path included: the encoder's 6,656
   rows at the 512 s bucket, the 3,968-row prompt's projections, decode
   attention over ~4,000 keys of an 8192-slot cache; the fused decode FFN at
   0.6B and 1.7B widths and the Q8 probes at the decode shapes, which are
   instantiations of the shipped GEMV: one line a case gives the four
   variants' times beside the bound and the differences that isolate one
   cost each), with the tolerance stated on each
   line (integer-valued cases bitwise): kernel / plain times from CUDA
   events, the bound (the least time the card could take for the case's
   bytes and operations) and, for the attention kernels, one
   ``scaled_dot_product_attention`` call on the same inputs as a yardstick
   (decode attention and flash prefill are also held against their split
   schedules in torch at the kernel's split count, and each case names its
   clusters and how many of them the card holds at once; flash prefill and
   the fused FFN are also checked bitwise run to run, the fused FFN row by
   row against T=1 calls); and at the tensor-parallel shard shapes that
   ``Qwen3ASRModel(mesh=)`` gives one rank (0.6B and 1.7B at tp=2, 1.7B at
   tp=4: the o/down partials without the residual epilogue, qkv/gate-up with
   the norm prologue, the 0.6B encoder's linears at tp=2, attention on 4 and
   2 KV heads)
   (no single PyTorch call computes Q8_0 dequant-matmul or the fused FFN;
   ``fused_ffn_step`` is timed beside the decoder's six-launch FFN half);
4. a narrow model (head dim 128, two query heads per KV head) transcribed on
   the card and on the CPU (plain versions): logits and greedy tokens
   compared, then one prefill of 128 rows at KV capacity 8192 (flash-prefill
   kernel on the card, ``attention_chunked`` on the CPU);
5. a 0.6B-width Q8_0 GGUF with random weights from a seed, served by the
   port's engine server through the wire loop on in-memory pipes, driven
   along seven paths, each with the kernels' launch counts set to 0 just
   before it and read just after:
   - slice: a 2 s and a 12 s speech-like request and silence, one at a time
     (each speech request's decode captured once as a CUDA graph and every
     step a replay);
   - batch: four concurrent requests of 2-3 s, then four of 4-12 s, written
     at once so that the ones queued behind the first coalesce into one
     batched prefill and decode. Then, on the model and counted apart
     (``batch-model``), ``transcribe_batch`` against per-stream
     ``transcribe`` on clips of one bucket length, and decode ms/step and
     aggregate tokens/s at B = 1, 2, 4, 8;
   - longform: one 156 s recording with no options (VAD over all of it,
     windows of at most 28 s, one batched decode);
   - single-pass: one 300 s recording with ``"long_form": false``, decoded as
     one context: a prompt of 3,968 rows against a KV cache of 8192 slots,
     whose prefill attention is the flash-prefill kernel, once a layer;
   - fused-ffn: the 12 s request of ``slice`` with ``LWT_FUSED_FFN=1``
     (``fused_ffn_step`` once a layer every decode step), alternated three
     times with the default route for the decode ms/step of each; the replies
     of each route must be identical run to run;
   - interim (session reuse on; the five paths above run with
     ``LIGHT_WHISPER_DISABLE_SESSION_REUSE=1``, as the server served every
     request before its sessions): the app's interim loop, with the reference's
     interim decode budget of 96 tokens. One recording ticks on a named stream
     at 3, 4, ..., 9 s (session hits, incremental prefills and VAD prefix reuse
     required), each tick printed beside the stateless ``inference_ms`` of the
     same window (and, where the texts differ on the same trimmed bytes, the
     token where they part and the stateless top-2 gap there); two streams'
     ticks written at once while a job holds the
     device coalesce into batched ticks (fresh, then extending; no degrade), whose replies
     must equal the same ticks one at a time. Then, on the model, ticks held
     against stateless ``transcribe`` under ``narrow_verdict``'s rule;
   - dictate: ``engine_cli``'s dictation loop (``engine_cli.dictate``) on the
     served model, in-process: a 12 s speech-like clip in 250 ms blocks paced
     in real time through the recording controller (interim ticks on its own
     thread at the adaptive 140-460 ms interval, then finalize); the events'
     names and fields must be the reference's, and the final text a fresh
     ``IncrementalTranscriber`` transcribe's under ``narrow_verdict`` (or, from
     the interim cache, the last tick's). Q8 kernels #1-#3 and the batched
     attention (every decode step, B=1 included) must launch on it, the fused
     FFN not;
6. precise: the same artifact served with ``LIGHT_WHISPER_PRECISE=1`` (dense
   f32 weights, f32 compute and KV cache) through the wire loop, the 2 s and
   12 s requests of ``slice``: no kernel launched, every KV cache f32, the
   card's f32 matmul held against float64 (TF32 would show); then the narrow
   model in precise mode on the card and on the CPU;
7. train: one fine-tuning step of the narrow model in f32 on the card and on
   the CPU (loss and every gradient compared), then five steps at the 0.6B
   widths (bf16 matrices, B = 4 clips of 10 s, 48 labels each) through a
   dp1 x tp1 mesh on NCCL (the loss must fall, no kernel launched) and a
   checkpoint of that state saved and restored bitwise;
8. mesh: the artifact as ``Qwen3ASRModel(mesh=)`` on a one-rank NCCL group
   (dp1 x tp1: the tensor-parallel route and the sessions' cache placement)
   against the unmeshed model on the same inputs under ``narrow_verdict``'s
   rule: the 12 s clip, a fresh then an extending tick, ``transcribe_batch``
   of four clips and the dp-split batch at dp=1 (with ``LWT_FUSED_FFN=1`` set:
   the fused FFN must stay off under a mesh), each decode ms/step beside the
   unmeshed one; then ``encode_chunks_sp`` at sp=1 on the 300 s clip's mel
   against ``encode_chunks``. Counted in the kernels line's launches;
9. ``engine_cli serve`` in a subprocess, twice: from a copy of the package
   with an empty kernel build directory (cold: one transcribe) and from the
   checkout (warm: two, the first's ``inference_ms`` beside the second's),
   each timed from spawn to its init reply; then ``engine_cli dictate`` of a
   4 s WAV in real time in a fresh process, with neither ``--device`` nor
   ``--engine`` (the engine from ``LIGHT_WHISPER_ASR_ENGINE``): one ``final``
   event, and its log line must name ``cuda``.

``LIGHT_WHISPER_FORCE_CPU`` would move the port to the CPU: the script
refuses to run with it set, and no child process inherits it.

Then the ``nvidia-smi`` line, a JSON line with one entry per kernel and, as
the last line, ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero without that line. Nothing of JAX and nothing of the JAX package
``light_whisper_tpu`` is imported: the model's widths, its random tensors
and the speech-like audio are built by the port and by this script.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 5
CARD_TIMEOUT_S = 60
TIE_BAND = 1e-3  # top-2 logit gap within which a greedy flip is a tie (docs/SERVING.md)
# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
L2_BYTES = 50 * 2**20
ENC_LAYERS = 18  # Qwen3-ASR 0.6B's encoder depth


class PhaseError(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# phase 1-2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=CARD_TIMEOUT_S,
    )
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_identify(torch) -> str:
    line = card_line()
    say(f"phase identify: ok card={line!r} torch={torch.__version__} cuda={torch.version.cuda} "
        f"device_count={torch.cuda.device_count()}")
    return line


def phase_build():
    from light_whisper_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    built = time.perf_counter() - t0
    srcs = [os.path.relpath(p, REPO) for p in _build.sources()]
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:  # names the kernel of the lines after it
            say(f"  ptxas: entry {line.split(chr(39))[1][:100]}")
        elif "registers" in line or "spill" in line or "smem" in line:
            say(f"  ptxas: {line.strip()}")
    say(f"phase build: ok {srcs} -> {os.path.relpath(str(_build.build()), REPO)} in {built:.1f} s")


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions


def _time_ms(torch, fn, calls, batches=5):
    """Median over ``batches`` of the mean per-call device time of ``calls``
    back-to-back calls (a sleep kernel queued first keeps host dispatch out
    of the window)."""
    fn(0)
    torch.cuda.synchronize()
    means = []
    for _ in range(batches):
        if hasattr(torch.cuda, "_sleep"):
            torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(calls):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / calls)
    means.sort()
    return means[len(means) // 2]


def _bf16_ulp(torch, ref):
    """One bf16 ulp at each element of ``ref`` (8 significant bits)."""
    mag = ref.abs().clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def bound_ms(nbytes: float, flops: float):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the bf16 tensor-core rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def q8_work(T, N, K, extra_bytes=0):
    """Bytes and operations of a Q8_0 product: bf16 x [T, K], int8 quants and
    bf16 scales [N, K/32], f32 out [T, N]."""
    return T * K * 2 + N * K + N * (K // 32) * 2 + T * N * 4 + extra_bytes, 2 * T * N * K


def attention_work(q, n_kv, streams):
    """Bytes and operations of causal attention as this run's data needs them:
    ``streams`` holds (first position, rows) of each cache; the live K/V rows
    of each are read once, row t sees keys 0..first + t."""
    rows, n_heads, hd = sum(r for _, r in streams), q.shape[-2], q.shape[-1]
    live = sum(first + r for first, r in streams)
    keys_seen = sum(r * first + r * (r + 1) // 2 for first, r in streams)
    nbytes = q.numel() * q.element_size() + 2 * n_kv * live * hd * 2 + rows * n_heads * hd * 4
    return nbytes, 4 * hd * n_heads * keys_seen


def sdpa_rows(torch, q, start, capacity):
    """A ``scaled_dot_product_attention`` call computing the rows' attention
    (T rows at ``start``.., GQA, a boolean position mask over the whole
    cache) on one layer's ``[Hkv, C, hd]`` K/V."""
    T = q.shape[0]
    qb = q.to(torch.bfloat16).transpose(0, 1)[None].contiguous()  # [1, Hq, T, hd]
    mask = torch.arange(capacity, device=q.device)[None, :] <= (start + torch.arange(T, device=q.device))[:, None]

    def call(k_layer, v_layer):
        out = torch.nn.functional.scaled_dot_product_attention(qb, k_layer[None], v_layer[None], attn_mask=mask,
                                                                enable_gqa=True)
        return out[0].transpose(0, 1)  # [T, Hq, hd]

    return call


def zero_past(cache, live):
    """``cache`` with its slots past each position zeroed, for the
    ``scaled_dot_product_attention`` yardstick: on the 1e4 junk the kernels
    are checked with there, SDPA's bf16 path (torch 2.11 on the H100) let it
    through the mask into some streams (max|d| ~1e4). The live K/V, and so
    the function and its work, are the same."""
    return cache.masked_fill(~live, 0)


def q8_schedule(T, N, K) -> str:
    """The Q8 kernel's schedule for a call, and how many of its clusters the
    card holds at once (T > 8)."""
    from light_whisper_tpu_torch.ops import q8_matmul as q8

    splits = q8.schedule_splits(T, N, K)
    if T <= q8.FUSED_MAX_ROWS:
        return f"[GEMV, S={splits}]"
    return f"[tile 64x{q8.TILE_N}, S={splits}, {q8.resident_clusters(N, K)} clusters resident]"


def phase_kernels(torch):
    from light_whisper_tpu_torch.ops import decode_attention as da
    from light_whisper_tpu_torch.ops import flash_prefill as fp
    from light_whisper_tpu_torch.ops import fused_ffn as ffn
    from light_whisper_tpu_torch.ops import q8_matmul as q8
    from light_whisper_tpu_torch.scripts import exp_q8_compute_bound as cb
    from light_whisper_tpu_torch.scripts import exp_q8_kperm_probe as kp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    results = {}

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def weights(L, N, K):
        q = torch.randint(-127, 128, (L, N, K), generator=gen, device=dev, dtype=torch.int8)
        s = (torch.rand((L, N, K // 32), generator=gen, device=dev) * 0.02 / 127 + 1e-4).to(torch.bfloat16)
        return q, s

    def record(form, case, err, tol, ms, plain_ms, bitwise=False, tol_txt=None, work=None, library=None,
               yardstick=None, note=""):
        ok = err == 0 if bitwise else err <= tol
        if tol_txt is not None:  # an elementwise criterion, already held by the caller
            ok = True
        else:
            tol_txt = "bitwise" if bitwise else f"tol={tol:.3g}"
        bound, bound_by = bound_ms(*work) if work else (None, None)
        library_ms, library_err = library if library else (None, None)
        extra = ""
        if bound is not None:
            extra += f" bound={bound:.4f} ms ({bound_by})"
        if library_ms is not None:
            extra += f" sdpa={library_ms:.4f} ms (sdpa max|d|={library_err:.3g})"
        if yardstick is not None:
            extra += f" {yardstick[0]}={yardstick[1]:.4f} ms"
        say(f"  {form} {case}: max|d|={err:.3g}{note} {tol_txt} kernel={ms:.4f} ms plain={plain_ms:.4f} ms{extra} "
            f"{'ok' if ok else 'FAIL'}")
        require(ok, f"{form} {case}: max|d| {err} over {tol_txt}")
        results.setdefault(form, []).append(
            {"case": case, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
             "bound_by": bound_by, "library_ms": library_ms})

    def check(form, case, kernel_fn, plain_fn, calls, tol_rel=1e-4, tol_abs=None, ulp_of=None, work=None,
              library_fn=None, ulp_or_rel=False, yardstick_fn=None, split_fn=None):
        got = kernel_fn(0)
        want = plain_fn(0)
        torch.cuda.synchronize()

        def held(ref, what):
            """max|d| of the kernel from ``ref``, the tolerance and, for an
            elementwise criterion, its text (already held here)."""
            diff = (got.float() - ref.float()).abs()
            err = float(diff.max())
            if ulp_or_rel:
                # a bf16 output of f32 sums taken in another order: one bf16 ulp of
                # each value, or tol_rel of max|ref| where the sum cancels
                ulp = _bf16_ulp(torch, torch.maximum(got.float().abs(), ref.float().abs()))
                limit = torch.clamp_min(ulp * 1.0001, tol_rel * max(1.0, float(ref.float().abs().max())))
                worst = float((diff / limit).max())
                require(worst <= 1.0, f"{form} {case}: max|d| {err:.3g} from the {what} version is {worst:.3g} x "
                                      f"(1 bf16 ulp or {tol_rel:g} max|ref|)")
                return err, worst, f"<= 1 bf16 ulp or {tol_rel:g} max|ref| elementwise (worst {worst:.2f} of it)"
            if ulp_of is not None:
                # bf16(res + bf16(acc)): f32 sums taken in another order may round
                # bf16(acc) one ulp apart, i.e. one bf16 ulp of max(|acc|, |out|)
                # (plus tol_rel of max|acc| when the norm prologue's scale, summed in
                # another order, may move a normalised input by one bf16 ulp)
                acc = ulp_of(0)
                ulp = _bf16_ulp(torch, torch.maximum(ref.abs(), acc.abs()))
                slack = tol_rel * max(1.0, float(acc.abs().max()))
                bad = diff > ulp * 1.0001 + slack
                require(not bool(bad.any()), f"{form} {case}: {int(bad.sum())} elements over 1 bf16 ulp + "
                                             f"{slack:.3g} from the {what} version (max|d| {err:.3g})")
                worst = float((diff / ulp).max())  # reported in ulps
                return err, worst, (f"<= 1 bf16 ulp of max(|acc|,|out|) (+1e-3 max|acc| with norm) elementwise "
                                    f"(worst {worst:.2f} ulp)")
            tol = tol_abs if tol_abs is not None else tol_rel * max(1.0, float(ref.abs().max()))
            return err, tol, None

        err, tol, tol_txt = held(want, "plain")
        note = ""
        if split_fn is not None:
            # the kernel's own split schedule in torch, held to the same criterion (inside a
            # split the f32 sums run in another order)
            split_err, split_tol, split_txt = held(split_fn(0), "split plain")
            require(split_txt is not None or split_err <= split_tol,
                    f"{form} {case}: {split_err:.3g} from the split plain version (tol {split_tol:.3g})")
            note = f" (split plain {split_err:.3g})"
        library = None
        if library_fn is not None:
            # the yardstick computes the same function: a wrong mask would time another one
            lib_err = float((library_fn(0).float() - want).abs().max())
            require(lib_err <= 5e-2, f"{form} {case}: the sdpa yardstick differs by {lib_err:.3g} (tol 5e-2, bf16 out)")
            library = (_time_ms(torch, library_fn, calls), lib_err)
        yardstick = yardstick_fn and (yardstick_fn[0], _time_ms(torch, yardstick_fn[1], calls))
        record(form, case, err, tol, _time_ms(torch, kernel_fn, calls), _time_ms(torch, plain_fn, calls),
               tol_txt=tol_txt, work=work, library=library, yardstick=yardstick, note=note)

    # -- 2D: logits head at decode; encoder at 12 s (156 rows) and at the
    # single-pass request's 512 s bucket (6,656 rows) --------------------------
    def bf16_ref(x, wd):
        # a reference reading of the tensor-core rate: x against a bf16 weight dequantised
        # ahead of time and held resident (twice the int8 bytes; not the function's library call)
        return ("bf16 matmul ref", lambda i: torch.matmul(x, wd[i % wd.shape[0]].t()))

    for case, T, N, K in (("logits T=1 152576x1024", 1, 152576, 1024),
                          # every row of an interim tick's segment (draft verification)
                          ("logits T=128 152576x1024", 128, 152576, 1024),
                          ("logits T=192 152576x1024", 192, 152576, 1024),
                          ("enc.fc2 T=156 896x3584", 156, 896, 3584),
                          ("enc.conv_out T=156 896x7680", 156, 896, 7680),
                          ("enc.fc1 T=6656 3584x896", 6656, 3584, 896),
                          ("enc.fc2 T=6656 896x3584", 6656, 896, 3584),
                          ("enc.conv_out T=6656 896x7680", 6656, 896, 7680)):
        # a weight that fits in the 50 MB L2 gets the encoder's 18 distinct copies, cycled, so
        # that each call reads it from HBM as the encoder's layers do
        n_copies = 1 if N * K > L2_BYTES else ENC_LAYERS
        qw, sw = weights(n_copies, N, K)
        wd = q8.dequantize(qw, sw)
        x = randn(T, K).to(torch.bfloat16)
        splits = q8.schedule_splits(T, N, K)
        check("q8_matmul", f"{case} {q8_schedule(T, N, K)}", lambda i: q8.q8_matmul(x, qw[i % n_copies], sw[i % n_copies]),
              lambda i: q8.q8_matmul_plain(x, qw[i % n_copies], sw[i % n_copies]), calls=max(8, n_copies),
              work=q8_work(T, N, K), yardstick_fn=bf16_ref(x, wd),
              split_fn=lambda i: q8.q8_matmul_split_plain(x, qw[i % n_copies], sw[i % n_copies], splits))
        del qw, sw, wd

    # -- stacked: decoder projections at prefill (28 layers, cycled); 3,968
    # rows is the single-pass request's prompt --------------------------------
    L = 28
    proj = {"qkv": (4096, 1024), "o": (1024, 2048), "gateup": (6144, 1024), "down": (1024, 3072)}
    stacks = {name: weights(L, N, K) for name, (N, K) in proj.items()}
    deq = {name: q8.dequantize(*stacks[name]) for name in proj}
    # T=128 and 256: an interim tick's segment prefill (the product takes no
    # position: a rollback start changes nothing here)
    for T in (64, 128, 192, 256, 3968):
        for name, (N, K) in proj.items():
            qw, sw = stacks[name]
            x = randn(T, K).to(torch.bfloat16)
            splits = q8.schedule_splits(T, N, K)
            check("q8_matmul_stacked", f"{name} T={T} {N}x{K} {q8_schedule(T, N, K)}",
                  lambda i: q8.q8_matmul_stacked(x, qw, sw, i % L),
                  lambda i: q8.q8_matmul_plain(x, qw[i % L], sw[i % L]), calls=L, work=q8_work(T, N, K),
                  yardstick_fn=bf16_ref(x, deq[name]),
                  split_fn=lambda i: q8.q8_matmul_split_plain(x, qw[i % L], sw[i % L], splits))

    # -- stacked-fused at decode (T=1) ---------------------------------------
    eps = 1e-6
    # T=1: one stream; T=8: the batched decode at B=8 (48 KB of staged x at K=3072)
    for T, case, name, with_norm, with_res in ((1, "qkv +norm", "qkv", True, False),
                                               (1, "o +residual", "o", False, True),
                                               (1, "down +norm +residual", "down", True, True),
                                               (8, "qkv +norm", "qkv", True, False),
                                               (8, "down +residual", "down", False, True)):
        N, K = proj[name]
        qw, sw = stacks[name]
        x = randn(T, K).to(torch.bfloat16)
        norm_w = (1.0 + randn(K, scale=0.1)) if with_norm else None
        res = randn(T, N).to(torch.bfloat16) if with_res else None
        extra = (K * 4 if with_norm else 0) + (T * N * 2 if with_res else 0)
        check("q8_matmul_stacked_fused", f"{case} T={T} {N}x{K} {q8_schedule(T, N, K)}",
              lambda i: q8.q8_matmul_stacked_fused(x, qw, sw, i % L, norm_w=norm_w, eps=eps, residual=res),
              lambda i: q8.q8_matmul_fused_plain(x, qw[i % L], sw[i % L], norm_w, eps, res),
              split_fn=lambda i: q8.q8_matmul_fused_plain(x, qw[i % L], sw[i % L], norm_w, eps, res,
                                                         splits=q8.GEMV_SPLITS),
              calls=L, tol_rel=1e-3 if with_norm else 0.0,
              ulp_of=(lambda i: q8.q8_matmul_fused_plain(x, qw[i % L], sw[i % L], norm_w, eps, None))
              if with_res else None, work=q8_work(T, N, K, extra), yardstick_fn=bf16_ref(x, deq[name]))
    del deq

    # -- row independence, bitwise: the card-side guarantee behind batched = alone --
    N, K = proj["qkv"]
    qw, sw = stacks["qkv"]
    x8, res8, nw = randn(8, K).to(torch.bfloat16), randn(8, N).to(torch.bfloat16), 1.0 + randn(K, scale=0.1)
    for T in (2, 4, 8):
        rows = q8.q8_matmul_stacked_fused(x8[:T], qw, sw, 3, norm_w=nw, eps=eps, residual=res8[:T])
        alone = torch.cat([q8.q8_matmul_stacked_fused(x8[t:t + 1], qw, sw, 3, norm_w=nw, eps=eps,
                                                      residual=res8[t:t + 1]) for t in range(T)])
        record("q8_matmul_stacked_fused", f"rows of T={T} vs each row at T=1, +norm +residual {N}x{K}",
               float((rows - alone).abs().max()), 0.0, 0.0, 0.0, bitwise=True)
    x192 = randn(192, K).to(torch.bfloat16)
    whole = q8.q8_matmul_stacked(x192, qw, sw, 3)
    for lo in (0, 64):
        tile = q8.q8_matmul_stacked(x192[lo:lo + 64], qw, sw, 3)
        record("q8_matmul_stacked", f"rows {lo}-{lo + 63} of T=192 vs a T=64 call {N}x{K}",
               float((whole[lo:lo + 64] - tile).abs().max()), 0.0, 0.0, 0.0, bitwise=True)

    # -- integer-valued cases: bitwise, on both kernels and across split edges ----
    def int_case(T, N, K):
        qi = torch.randint(-127, 128, (2, N, K), generator=gen, device=dev, dtype=torch.int8)
        si = torch.full((2, N, K // 32), 0.5, device=dev, dtype=torch.bfloat16)
        xi = torch.randint(-4, 4, (T, K), generator=gen, device=dev).to(torch.bfloat16)
        return qi, si, xi

    for T, N, K in ((1, 1024, 1024), (8, 1024, 3072), (9, 1024, 3072), (6656, 896, 7680)):
        qi, si, xi = int_case(T, N, K)
        got = q8.q8_matmul(xi, qi[1], si[1])
        want = q8.q8_matmul_plain(xi, qi[1], si[1])
        record("q8_matmul", f"integer T={T} {N}x{K} {q8_schedule(T, N, K)}", float((got - want).abs().max()),
               0.0, 0.0, 0.0, bitwise=True)
    qi, si, xi = int_case(96, 1024, 1024)
    got = q8.q8_matmul_stacked(xi, qi, si, 1)
    want = q8.q8_matmul_plain(xi, qi[1], si[1])
    record("q8_matmul_stacked", "integer T=96", float((got - want).abs().max()), 0.0, 0.0, 0.0, bitwise=True)
    qi, si, xi = int_case(4, 1024, 1024)
    res = torch.randint(-64, 64, (4, 1024), generator=gen, device=dev).to(torch.bfloat16)
    got = q8.q8_matmul_stacked_fused(xi, qi, si, 1, residual=res)
    want = q8.q8_matmul_fused_plain(xi, qi[1], si[1], None, eps, res)
    record("q8_matmul_stacked_fused", "integer T=4 +residual", float((got - want).abs().max()), 0.0,
           0.0, 0.0, bitwise=True)
    del qi, si, xi

    # -- the fused decode FFN (the LWT_FUSED_FFN route), layers cycled, at 0.6B and 1.7B widths --
    def ffn_cases(D, F, gq, gs, dq, ds, label=""):
        ffn_bytes = D * 2 * F + 2 * F * (D // 32) * 2 + D * F + D * (F // 32) * 2  # quants and scales a layer
        for T in (1, 8):
            x = randn(T, D, scale=3.0).to(torch.bfloat16)
            norm_w = 1.0 + randn(D, scale=0.1)

            def unfused_half(i, x=x, norm_w=norm_w):
                # the decoder's default FFN half: six launches
                gateup = q8.q8_matmul_stacked_fused(x, gq, gs, i % L, norm_w=norm_w, eps=eps)
                gate, up = torch.chunk(gateup, 2, dim=-1)
                inner = (torch.nn.functional.silu(gate) * up).to(torch.bfloat16)
                return q8.q8_matmul_stacked_fused(inner, dq, ds, i % L, residual=x).to(torch.bfloat16)

            check("fused_ffn_step", f"T={T} D={D} F={F}{label}",
                  lambda i: ffn.fused_ffn_step(x, norm_w, gq, gs, dq, ds, i % L, eps),
                  lambda i: ffn.fused_ffn_step_plain(x, norm_w, gq, gs, dq, ds, i % L, eps),  # the kernel's tile
                  calls=L, tol_rel=1e-3, work=(ffn_bytes + T * D * 2 + D * 4 + T * D * 4, 2 * T * 3 * F * D),
                  yardstick_fn=("six-launch half", unfused_half))
            again = [ffn.fused_ffn_step(x, norm_w, gq, gs, dq, ds, 5, eps) for _ in range(2)]
            record("fused_ffn_step", f"run to run T={T} D={D} F={F}", float((again[0] - again[1]).abs().max()),
                   0.0, 0.0, 0.0, bitwise=True)
        x8 = randn(8, D, scale=3.0).to(torch.bfloat16)
        norm_w = 1.0 + randn(D, scale=0.1)
        rows = ffn.fused_ffn_step(x8, norm_w, gq, gs, dq, ds, 3, eps)
        alone = torch.cat([ffn.fused_ffn_step(x8[t:t + 1], norm_w, gq, gs, dq, ds, 3, eps) for t in range(8)])
        record("fused_ffn_step", f"rows of T=8 vs each row at T=1 D={D} F={F}", float((rows - alone).abs().max()),
               0.0, 0.0, 0.0, bitwise=True)

    gq, gs = stacks["gateup"]
    dq, ds = stacks["down"]
    D, F = proj["down"]
    ffn_cases(D, F, gq, gs, dq, ds)
    h = randn(8, D).to(torch.bfloat16)
    check("fused_gateup_silu", f"T=8 D={D} F={F}",
          lambda i: ffn.fused_gateup_silu(h, gq, gs, i % L),
          lambda i: ffn.fused_gateup_silu_plain(h, gq, gs, i % L), calls=L, ulp_or_rel=True,
          work=(2 * F * D + 2 * F * (D // 32) * 2 + 8 * D * 2 + 8 * F * 2, 2 * 8 * 2 * F * D))
    # Qwen3-ASR 1.7B's decoder FFN: two down row groups a CTA in shared memory
    D7, F7 = 2048, 6144
    gq7, gs7 = weights(L, 2 * F7, D7)
    ffn_cases(D7, F7, gq7, gs7, *weights(L, D7, F7), label=" (1.7B widths)")

    # -- the Q8 probes at the 0.6B decode shapes, layers cycled: each variant is the shipped
    # GEMV's body (csrc/q8_gemv.cuh) with another per-chunk term, so the differences of their
    # times isolate one cost each ----------------------------------------------------------
    bk = cb.PERM_BLOCK_K
    for name in ("qkv", "gateup", "down"):
        N, K = proj[name]
        qw, sw = stacks[name]
        qp = kp.permute_kaxis(qw, bk).contiguous()
        for T in (1, 8):
            x = randn(T, K).to(torch.bfloat16)
            xp = kp.permute_kaxis(x, bk).contiguous()
            check("q8_probe", f"noscale {name} T={T} {N}x{K}",
                  lambda i: cb.q8_probe("noscale", x, qw[i % L], sw[i % L]),
                  lambda i: cb.noscale_plain(x, qw[i % L]), calls=L, work=q8_work(T, N, K),
                  split_fn=lambda i: cb.noscale_split_plain(x, qw[i % L]))
            check("q8_probe", f"load {name} T={T} {N}x{K}",  # integer sums: bitwise
                  lambda i: cb.q8_probe("load", x, qw[i % L], sw[i % L]),
                  lambda i: cb.load_plain(qw[i % L], T), calls=L, tol_abs=0.0,
                  work=(q8_work(T, N, K)[0], 0))
            check("q8_matmul_stacked_perm", f"{name} T={T} {N}x{K} block_k={bk}",
                  lambda i: kp.q8_matmul_stacked_perm_2d(xp, qp, sw, i % L, bk),
                  lambda i: kp.q8_matmul_perm_plain(xp, qp[i % L], sw[i % L], bk), calls=L,
                  work=q8_work(T, N, K),
                  split_fn=lambda i: kp.q8_matmul_perm_split_plain(xp, qp[i % L], sw[i % L], bk))
            ms = {"load": results["q8_probe"][-1]["ms"], "noscale": results["q8_probe"][-2]["ms"],
                  "full": _time_ms(torch, lambda i: q8.q8_matmul_stacked(x, qw, sw, i % L), L),
                  "permexact": results["q8_matmul_stacked_perm"][-1]["ms"]}
            bound = bound_ms(*q8_work(T, N, K))[0]
            say(f"  probe {name} T={T} {N}x{K} {q8_schedule(T, N, K)}: "
                + " / ".join(f"{v} {t:.4f}" for v, t in ms.items()) + f" ms, bound {bound:.4f} ms; "
                + " ".join(f"{k}={v:.4f}" for k, v in cb.terms(ms, bound).items())
                + f"; load<=noscale<=full<=permexact: {ms['load'] <= ms['noscale'] <= ms['full'] <= ms['permexact']}")
        # the probes run the shipped GEMV's instructions at every T: a row is the same batched and alone
        x8 = randn(8, K).to(torch.bfloat16)
        for variant, form, x_in, call in (
                ("noscale", "q8_probe", x8, lambda rows: cb.q8_probe("noscale", rows, qw[3], sw[3])),
                ("perm", "q8_matmul_stacked_perm", kp.permute_kaxis(x8, bk).contiguous(),
                 lambda rows: kp.q8_matmul_stacked_perm_2d(rows, qp, sw, 3, bk))):
            rows = call(x_in)
            alone = torch.cat([call(x_in[t:t + 1]) for t in range(8)])
            record(form, f"rows of T=8 vs each row at T=1, {variant} {name} {N}x{K}",
                   float((rows - alone).abs().max()), 0.0, 0.0, 0.0, bitwise=True)
        if name == "gateup":
            x = randn(8, K).to(torch.bfloat16)
            check("q8_matmul_perm", f"gateup T=8 {N}x{K} block_k={bk}, x permuted in the call",
                  lambda i: kp.q8_matmul_perm(x, qp[i % L], sw[i % L], bk),
                  lambda i: q8.q8_matmul_plain(x, qw[i % L], sw[i % L]), calls=L, work=q8_work(8, N, K))
        del qp
    # block_k 2048, the reference's bench block, on the 1.7B gate/up stack of the FFN cases
    N7, K7 = gq7.shape[1:]
    qp7 = kp.permute_kaxis(gq7, 2048).contiguous()
    for T in (1, 8):
        xp = kp.permute_kaxis(randn(T, K7).to(torch.bfloat16), 2048).contiguous()
        check("q8_matmul_stacked_perm", f"gateup 1.7B T={T} {N7}x{K7} block_k=2048",
              lambda i: kp.q8_matmul_stacked_perm_2d(xp, qp7, gs7, i % L, 2048),
              lambda i: kp.q8_matmul_perm_plain(xp, qp7[i % L], gs7[i % L], 2048), calls=L,
              work=q8_work(T, N7, K7),
              split_fn=lambda i: kp.q8_matmul_perm_split_plain(xp, qp7[i % L], gs7[i % L], 2048))
    del qp7, gq7, gs7

    # -- decode attention: 0.6B heads, stacked caches --------------------------
    Hq, Hkv, hd = 16, 8, 128

    def stacked_cache(C, layers=L):
        return randn(layers, Hkv, C, hd).to(torch.bfloat16), randn(layers, Hkv, C, hd).to(torch.bfloat16)

    def clusters(T, B, C, splits):
        """The launch's clusters and how many of them the card holds at once."""
        units = B * Hkv * -(-(Hq // Hkv * T) // da.TILE_ROWS)
        return f"({units} clusters, {da.resident_clusters(T, Hq, Hkv, C, hd, splits)} resident)"

    # each case also against the kernel's split schedule in torch at its split count S
    def decode_case(T, start, kc, vc):
        Lc, C = kc.shape[0], kc.shape[2]
        qx = randn(T, Hq, hd, scale=3.0)
        sdpa = sdpa_rows(torch, qx, start, C)
        splits = da.split_count(C)
        check("decode_attention", f"T={T} start={start} C={C} S={splits} {clusters(T, 1, C, splits)}",
              lambda i: da.decode_attention(qx, kc, vc, start, i % Lc),
              lambda i: da.decode_attention_plain(qx, kc, vc, start, i % Lc),
              calls=Lc, tol_abs=5e-3,  # bf16 rounding of p
              work=attention_work(qx, Hkv, [(start, T)]),
              library_fn=lambda i: sdpa(kc[i % Lc], vc[i % Lc]),
              split_fn=lambda i: da.attention_split_plain(qx, kc[i % Lc], vc[i % Lc], start, splits))

    C = 1024
    kc, vc = stacked_cache(C)
    for T, start in ((1, 0), (1, 200), (1, 1023), (64, 0), (64, 150), (64, 960)):
        decode_case(T, start, kc, vc)
    # one layer's [Hkv, C, hd] block: the batched prefill's per-stream attention
    for T, start in ((1, 511), (64, 0)):
        qx = randn(T, Hq, hd, scale=3.0)
        sdpa = sdpa_rows(torch, qx, start, C)
        splits = da.split_count(C)
        check("decode_attention_unstacked", f"T={T} start={start} C={C} S={splits} {clusters(T, 1, C, splits)}",
              lambda i: da.decode_attention_unstacked(qx, kc[i % L], vc[i % L], start),
              lambda i: da.attention_plain(qx, kc[i % L], vc[i % L], start),
              calls=L, tol_abs=5e-3, work=attention_work(qx, Hkv, [(start, T)]),
              library_fn=lambda i: sdpa(kc[i % L], vc[i % L]),
              split_fn=lambda i: da.attention_split_plain(qx, kc[i % L], vc[i % L], start, splits))
    del kc, vc
    # the single-pass decode: 447 steps after 3,968 prompt rows, at capacity 8192
    kc, vc = stacked_cache(8192)
    for start in (3968, 4414):
        decode_case(1, start, kc, vc)
    del kc, vc
    # the longest single-pass context; 8 layers cycled, so each call's K/V still comes from HBM
    kc, vc = stacked_cache(32768, layers=8)
    decode_case(1, 32767, kc, vc)
    del kc, vc

    # per-stream caches, junk past each stream's position (padded prompt tails)
    def batched_case(B, Cb, positions, Lb):
        kb = randn(B, Lb, Hkv, Cb, hd).to(torch.bfloat16)
        vb = randn(B, Lb, Hkv, Cb, hd).to(torch.bfloat16)
        for b, p in enumerate(positions):
            kb[b, :, :, p + 1:] = 1e4
            vb[b, :, :, p + 1:] = -1e4
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        qx = randn(B, Hq, hd, scale=3.0)
        qb = qx.to(torch.bfloat16)[:, :, None]  # [B, Hq, 1, hd]
        bmask = (torch.arange(Cb, device=dev)[None, :] <= pos[:, None].long())[:, None, None]  # [B, 1, 1, C]
        kz, vz = zero_past(kb, bmask[..., None]), zero_past(vb, bmask[..., None])  # [B, 1, 1, C, 1]
        splits = da.split_count(Cb)
        check("decode_attention_batched", f"B={B} C={Cb} S={splits} {clusters(1, B, Cb, splits)} pos={positions}",
              lambda i: da.decode_attention_batched(qx, kb, vb, pos, i % Lb, positions),
              lambda i: da.decode_attention_batched_plain(qx, kb, vb, pos, i % Lb),
              calls=Lb, tol_abs=5e-3, work=attention_work(qx, Hkv, [(p, 1) for p in positions]),
              library_fn=lambda i: torch.nn.functional.scaled_dot_product_attention(
                  qb, kz[:, i % Lb], vz[:, i % Lb], attn_mask=bmask, enable_gqa=True)[:, :, 0],
              split_fn=lambda i: da.decode_attention_batched_split_plain(qx, kb, vb, pos, i % Lb, splits))

    for B in (2, 8):
        for Cb in (1024, 2048):
            batched_case(B, Cb, [37, Cb - 1] if B == 2 else [0, 37, 511, Cb - 1, 3, 200, 700, Cb // 2], L)
    batched_case(8, 4096, [0, 4095, 37, 2048, 1, 4000, 700, 3000], 8)

    # -- flash prefill: prompts of more than 64 rows against caches of >= 8192 --
    # layers cycled so that the live K/V of each call comes from HBM; each case also against the
    # kernel's split schedule in torch at its split count S
    Lf = 8
    for T, start, Cf in ((3968, 0, 8192), (512, 32768 - 512, 32768), (65, 100, 8192), (128, 8064, 8192)):
        kf = randn(Lf, Hkv, Cf, hd).to(torch.bfloat16)
        vf = randn(Lf, Hkv, Cf, hd).to(torch.bfloat16)
        kf[:, :, start + T:] = 1e4  # junk past the last position must not leak in
        vf[:, :, start + T:] = -1e4
        qx = randn(T, Hq, hd, scale=3.0).to(torch.bfloat16)
        sdpa = sdpa_rows(torch, qx, start, Cf)
        live = (torch.arange(Cf, device=dev) < start + T)[:, None]
        kz, vz = zero_past(kf, live), zero_past(vf, live)
        splits, resident = fp.plan(T, Hq, Hkv, Cf)
        require(splits == fp.prefill_splits(T, Hq, Hkv, Cf),
                f"flash_prefill T={T} C={Cf}: the kernel splits {splits} ways, prefill_splits says "
                f"{fp.prefill_splits(T, Hq, Hkv, Cf)}")
        n_clusters = Hkv * -(-(Hq // Hkv * T) // fp.ROW_TILE)
        check("flash_prefill", f"T={T} start={start} C={Cf} S={splits} ({n_clusters} clusters, {resident} resident)",
              lambda i: fp.flash_prefill(qx, kf[i % Lf], vf[i % Lf], start),
              lambda i: fp.flash_prefill_plain(qx, kf[i % Lf], vf[i % Lf], start),  # the kernel's key tile
              calls=Lf, tol_abs=5e-3, work=attention_work(qx, Hkv, [(start, T)]),
              library_fn=lambda i: sdpa(kz[i % Lf], vz[i % Lf]),
              split_fn=lambda i: fp.flash_prefill_split_plain(qx, kf[i % Lf], vf[i % Lf], start, splits))
        again = [fp.flash_prefill(qx, kf[1], vf[1], start) for _ in range(2)]
        record("flash_prefill", f"run to run T={T} start={start} C={Cf}", float((again[0] - again[1]).abs().max()),
               0.0, 0.0, 0.0, bitwise=True)
        del kf, vf, kz, vz
    # -- tensor-parallel shard shapes (Qwen3ASRModel(mesh=)): one rank's share of the heads and
    # the FFN columns. Row-parallel o/down take the partial product (#2, no residual epilogue:
    # the ranks' f32 partials are summed first); column-parallel qkv/gateup keep the norm
    # prologue (#3); the encoder's sharded linears are #1; attention runs on Hkv/tp heads ----
    for label, D, Hq_, Hkv_, F, tp in (("0.6B tp=2", 1024, 16, 8, 3072, 2), ("1.7B tp=2", 2048, 16, 8, 6144, 2),
                                       ("1.7B tp=4", 2048, 16, 8, 6144, 4)):
        shard = {"qkv": ((Hq_ + 2 * Hkv_) * hd // tp, D), "o": (D, Hq_ * hd // tp),
                 "gateup": (2 * F // tp, D), "down": (D, F // tp)}
        for name, (N, K) in shard.items():
            qw, sw = weights(L, N, K)
            wd = q8.dequantize(qw, sw)
            for T in (1, 8):
                x = randn(T, K).to(torch.bfloat16)
                if name in ("o", "down"):
                    check("q8_matmul_stacked", f"{label} {name} partial T={T} {N}x{K} {q8_schedule(T, N, K)}",
                          lambda i: q8.q8_matmul_stacked(x, qw, sw, i % L),
                          lambda i: q8.q8_matmul_plain(x, qw[i % L], sw[i % L]), calls=L, work=q8_work(T, N, K),
                          yardstick_fn=bf16_ref(x, wd),
                          split_fn=lambda i: q8.q8_matmul_split_plain(x, qw[i % L], sw[i % L], q8.GEMV_SPLITS))
                    continue
                norm_w = 1.0 + randn(K, scale=0.1)
                check("q8_matmul_stacked_fused", f"{label} {name} +norm T={T} {N}x{K} {q8_schedule(T, N, K)}",
                      lambda i: q8.q8_matmul_stacked_fused(x, qw, sw, i % L, norm_w=norm_w, eps=eps),
                      lambda i: q8.q8_matmul_fused_plain(x, qw[i % L], sw[i % L], norm_w, eps, None),
                      split_fn=lambda i: q8.q8_matmul_fused_plain(x, qw[i % L], sw[i % L], norm_w, eps, None,
                                                                 splits=q8.GEMV_SPLITS),
                      calls=L, tol_rel=1e-3, work=q8_work(T, N, K, K * 4), yardstick_fn=bf16_ref(x, wd))
            del qw, sw, wd
    # the 0.6B encoder at tp=2 (7 of 14 heads, 1,792 of 3,584 FFN columns), 12 s (156 rows), 18 layers cycled
    E = ENC_LAYERS
    for case, N, K in (("enc.q/k/v 0.6B tp=2 T=156 448x896", 448, 896),
                       ("enc.fc1 0.6B tp=2 T=156 1792x896", 1792, 896),
                       ("enc.fc2 0.6B tp=2 T=156 896x1792", 896, 1792)):
        qw, sw = weights(E, N, K)
        wd = q8.dequantize(qw, sw)
        x = randn(156, K).to(torch.bfloat16)
        splits = q8.schedule_splits(156, N, K)
        check("q8_matmul", f"{case} {q8_schedule(156, N, K)}", lambda i: q8.q8_matmul(x, qw[i % E], sw[i % E]),
              lambda i: q8.q8_matmul_plain(x, qw[i % E], sw[i % E]), calls=E, work=q8_work(156, N, K),
              yardstick_fn=bf16_ref(x, wd),
              split_fn=lambda i: q8.q8_matmul_split_plain(x, qw[i % E], sw[i % E], splits))
        del qw, sw, wd
    # decode attention on a rank's heads: 8 over 4 KV heads (tp=2), 4 over 2 (1.7B tp=4)
    C = 1024
    splits = da.split_count(C)
    for Hq_, Hkv_ in ((8, 4), (4, 2)):
        kc = randn(L, Hkv_, C, hd).to(torch.bfloat16)
        vc = randn(L, Hkv_, C, hd).to(torch.bfloat16)
        for T, start in ((1, 200), (64, 150)):
            qx = randn(T, Hq_, hd, scale=3.0)
            sdpa = sdpa_rows(torch, qx, start, C)
            resident = da.resident_clusters(T, Hq_, Hkv_, C, hd, splits)
            check("decode_attention",
                  f"{Hq_}/{Hkv_} heads T={T} start={start} C={C} S={splits} ({resident} clusters resident)",
                  lambda i: da.decode_attention(qx, kc, vc, start, i % L),
                  lambda i: da.decode_attention_plain(qx, kc, vc, start, i % L),
                  calls=L, tol_abs=5e-3, work=attention_work(qx, Hkv_, [(start, T)]),
                  library_fn=lambda i: sdpa(kc[i % L], vc[i % L]),
                  split_fn=lambda i: da.attention_split_plain(qx, kc[i % L], vc[i % L], start, splits))
        del kc, vc
        positions = [0, 37, 511, C - 1, 3, 200, 700, C // 2]
        kb = randn(8, L, Hkv_, C, hd).to(torch.bfloat16)
        vb = randn(8, L, Hkv_, C, hd).to(torch.bfloat16)
        for b, p in enumerate(positions):
            kb[b, :, :, p + 1:] = 1e4
            vb[b, :, :, p + 1:] = -1e4
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        qx = randn(8, Hq_, hd, scale=3.0)
        qb = qx.to(torch.bfloat16)[:, :, None]
        bmask = (torch.arange(C, device=dev)[None, :] <= pos[:, None].long())[:, None, None]
        kz, vz = zero_past(kb, bmask[..., None]), zero_past(vb, bmask[..., None])
        check("decode_attention_batched", f"{Hq_}/{Hkv_} heads B=8 C={C} S={splits} pos={positions}",
              lambda i: da.decode_attention_batched(qx, kb, vb, pos, i % L, positions),
              lambda i: da.decode_attention_batched_plain(qx, kb, vb, pos, i % L),
              calls=L, tol_abs=5e-3, work=attention_work(qx, Hkv_, [(p, 1) for p in positions]),
              library_fn=lambda i: torch.nn.functional.scaled_dot_product_attention(
                  qb, kz[:, i % L], vz[:, i % L], attn_mask=bmask, enable_gqa=True)[:, :, 0],
              split_fn=lambda i: da.decode_attention_batched_split_plain(qx, kb, vb, pos, i % L, splits))
        del kb, vb, kz, vz

    n_cases = sum(len(v) for v in results.values())
    say(f"phase kernels: ok {n_cases} cases")
    return results


# ---------------------------------------------------------------------------
# model artifacts: Qwen3-ASR 0.6B widths and random tensors from a seed


def write_model(path: str, cfg, seed: int) -> None:
    """A Q8_0 GGUF of the port's ``synthetic.random_tensors(cfg, seed)``."""
    from light_whisper_tpu_torch.models.qwen3_asr import synthetic

    synthetic.write_model(path, cfg, seed)


def qwen3_asr_06b_config():
    from light_whisper_tpu_torch.models.qwen3_asr.synthetic import qwen3_asr_06b_config as config

    return config()


# ---------------------------------------------------------------------------
# phase 4: narrow model on the card vs the CPU


def narrow_verdict(ref_tokens, got_tokens, flips, band: float = TIE_BAND):
    """``None`` if the card's greedy tokens pass the narrow gate, else why not.

    ``flips`` holds (step, CPU top-2 gap) of each step whose teacher-forced
    argmax differs between the card and the CPU. Every flip must be a tie
    (gap within ``band``), and the card's tokens must equal the CPU's up to
    the first flip: all of them where there is none."""
    wide = [(step, gap) for step, gap in flips if gap > band]
    if wide:
        return f"argmax flips outside the {band:g} tie band: {wide}"
    first = min((step for step, _gap in flips), default=None)
    if first is None and got_tokens != ref_tokens:
        return f"card greedy {got_tokens} != CPU {ref_tokens} with no argmax flip"
    if first is not None and got_tokens[:first] != ref_tokens[:first]:
        return f"card greedy {got_tokens} parts from CPU {ref_tokens} before the first flip (step {first})"
    return None


def narrow_model():
    """(config, GGUF path) of the narrow model: head dim 128, two query heads
    a KV head, random Q8_0 weights from ``SEED`` (written once)."""
    from light_whisper_tpu_torch.models.qwen3_asr.config import AudioEncoderConfig, DecoderConfig, Qwen3ASRConfig

    vocab = 1024
    cfg = Qwen3ASRConfig(
        audio=AudioEncoderConfig(num_mel_bins=128, d_model=128, block_count=2, head_count=2,
                                 feed_forward_length=256, downsample_hidden_size=32, output_dim=256,
                                 max_source_positions=200),
        decoder=DecoderConfig(vocab_size=vocab, embedding_length=256, block_count=3,
                              feed_forward_length=512, head_count=4, head_count_kv=2, key_length=128,
                              context_length=32_768),
        audio_token_id=vocab - 4, bos_token_id=vocab - 3, eos_token_id=vocab - 2, pad_token_id=vocab - 1,
    )
    path = os.path.join(REPO, "build", "chip_smoke", f"narrow-seed{SEED}.gguf")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if not os.path.isfile(path):
        write_model(path, cfg, SEED)
    return cfg, path


def card_vs_cpu(torch, path: str, label: str, precise: bool = False, tol: float = 2e-2, steps: int = 12):
    """The model at ``path`` transcribes on the card and on the CPU: logits
    teacher-forced on the CPU's tokens compared step by step, and the card's
    greedy tokens held to ``narrow_verdict``. Returns (card model, CPU model)."""
    from light_whisper_tpu_torch.eval.speechlike import speechlike
    from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel

    audio = speechlike(2.0, seed=SEED)
    gpu = Qwen3ASRModel(path, device="cuda", max_new_tokens=steps, precise=precise)
    cpu = Qwen3ASRModel(path, device="cpu", max_new_tokens=steps, precise=precise)
    vocab = cpu.config.decoder.vocab_size
    ref_tokens = cpu.transcribe(audio).tokens
    ref_logits = cpu.teacher_forced_logits(audio, ref_tokens)
    got_logits = gpu.teacher_forced_logits(audio, ref_tokens)
    worst = 0.0
    flips = []
    for step, (r, g) in enumerate(zip(ref_logits, got_logits)):
        require(bool(torch.isfinite(g).all()), f"{label}: non-finite logits at step {step}")
        r, g = r[:vocab], g[:vocab]
        worst = max(worst, float((r - g).abs().max()) / max(1.0, float(r.abs().max())))
        if int(torch.argmax(r)) != int(torch.argmax(g)):
            top2 = torch.topk(r, 2).values
            flips.append((step, float(top2[0] - top2[1])))
    say(f"  {label}: greedy tokens {ref_tokens}; max|dlogit|/max|logit| = {worst:.3g}; {len(flips)} argmax flips")
    for step, gap in flips:
        say(f"  {label}: argmax flip at step {step}, CPU top-2 gap {gap:.3g} (tie band {TIE_BAND:g})")
    require(worst <= tol, f"{label} logits differ by {worst:.3g} (tol {tol:g} of max|logit|)")
    got_tokens = gpu.transcribe(audio).tokens
    verdict = narrow_verdict(ref_tokens, got_tokens, flips)
    require(verdict is None, f"{label}: {verdict}")
    return gpu, cpu


def phase_narrow(torch):
    from light_whisper_tpu_torch.eval.speechlike import speechlike
    from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec
    from light_whisper_tpu_torch.ops import flash_prefill as fp

    cfg, path = narrow_model()
    gpu, cpu = card_vs_cpu(torch, path, "narrow")

    # one prefill of more than 64 rows at capacity 8192: the flash-prefill
    # kernel on the card, attention_chunked on the CPU
    long_audio = speechlike(6.0, seed=SEED + 2)
    logits = {}
    for name, model in (("cpu", cpu), ("card", gpu)):
        request = model._prepare(long_audio)
        rows = len(request[2])
        route = dec._attention_route(dec.torch_dtype(cfg.decoder.compute_dtype), rows, 8192, model.device.type)
        require(rows > 64 and route == ("flash_prefill" if name == "card" else "attention_chunked"),
                f"{name}: {rows} prompt rows at capacity 8192 take {route}")
        cache = dec.init_cache(cfg.decoder, 8192, model.cache_dtype, model.device)
        before = fp.LAUNCHES["flash_prefill"]
        logits[name] = model._encode_and_prefill(*request, cache)[0].float().cpu()[: cfg.decoder.vocab_size]
        torch.cuda.synchronize()
        launched = fp.LAUNCHES["flash_prefill"] - before
        require(launched == (cfg.decoder.block_count if name == "card" else 0),
                f"{name}: flash_prefill launched {launched} times over {cfg.decoder.block_count} layers")
    r, g = logits["cpu"], logits["card"]
    require(bool(torch.isfinite(g).all()), "non-finite logits after the 8192-slot prefill")
    rel = float((r - g).abs().max()) / max(1.0, float(r.abs().max()))
    first_cpu, first_card = int(torch.argmax(r)), int(torch.argmax(g))
    top2 = torch.topk(r, 2).values
    gap = float(top2[0] - top2[1])
    say(f"  narrow prefill at C=8192 ({rows} rows): max|dlogit|/max|logit| = {rel:.3g}; first token "
        f"card {first_card} CPU {first_cpu} (CPU top-2 gap {gap:.3g})")
    require(rel <= 2e-2, f"8192-slot prefill logits differ by {rel:.3g} (tol 2e-2 of max|logit|)")
    require(first_card == first_cpu or gap <= TIE_BAND,
            f"first token {first_card} != {first_cpu} with top-2 gap {gap:.3g} over {TIE_BAND}")
    say("phase narrow: ok (card vs CPU plain versions, d_model 256, hd 128, G 2; prefill at C=8192)")


# ---------------------------------------------------------------------------
# phase 5: the slice through the wire loop


def _pcm_b64(audio) -> str:
    import numpy as np

    pcm = np.clip(np.round(np.asarray(audio) * 32767.0), -32768, 32767).astype("<i2")
    return base64.b64encode(pcm.tobytes()).decode()


class PipeClient:
    """The wire loop of ``engine_cli serve`` on a thread, over in-memory pipes."""

    def __init__(self, hooks):
        from light_whisper_tpu_torch.runtime.server import EngineServer

        r_in, w_in = os.pipe()
        r_out, w_out = os.pipe()
        self._to_server = os.fdopen(w_in, "w", encoding="utf-8")
        self._from_server = os.fdopen(r_out, "r", encoding="utf-8")
        server_in = os.fdopen(r_in, "r", encoding="utf-8")
        server_out = os.fdopen(w_out, "w", encoding="utf-8")
        self.server = EngineServer(hooks, stdin=server_in, stdout=server_out)

        def run():
            try:
                self.server.run()
            finally:
                server_out.close()
                server_in.close()

        self.thread = threading.Thread(target=run, name="engine-server", daemon=True)
        self.thread.start()

    def read(self) -> dict:
        line = self._from_server.readline()
        require(bool(line), "engine server closed its output")
        return json.loads(line)

    def send(self, *commands: dict) -> None:
        self._to_server.write("".join(json.dumps(c) + "\n" for c in commands))
        self._to_server.flush()

    def call(self, command: dict) -> dict:
        self.send(command)
        return self.read()

    def close(self):
        self._to_server.close()
        self.thread.join(timeout=120)
        require(not self.thread.is_alive(), "engine server thread did not stop")
        self._from_server.close()


def _flagship_path():
    cfg = qwen3_asr_06b_config()
    path = os.path.join(REPO, "build", "chip_smoke", f"qwen3-asr-0.6b-seed{SEED}.gguf")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if not os.path.isfile(path):
        t0 = time.perf_counter()
        write_model(path, cfg, SEED)
        say(f"  built {os.path.relpath(path, REPO)} ({os.path.getsize(path) / 2**20:.0f} MiB) "
            f"in {time.perf_counter() - t0:.1f} s")
    return path, cfg


def _transcribe_cmd(rid: int, audio, **options) -> dict:
    cmd = {"action": "transcribe", "request_id": rid, "audio_base64": _pcm_b64(audio),
           "audio_format": "pcm_s16le", "sample_rate": 16000}
    if options:
        cmd["options"] = options
    return cmd


def _median_ms(seconds) -> float:
    return sorted(seconds)[len(seconds) // 2] * 1000 if seconds else float("nan")


class Launches:
    """The kernels' launch counters, set to 0 just before a path and read just
    after it (``synchronize`` first, so that a fault surfaces in its path)."""

    def __init__(self, torch, counters):
        self.torch, self.counters, self.by_path = torch, counters, {}

    def start(self):
        for counter in self.counters:
            for key in counter:
                counter[key] = 0

    def read(self, path: str, required) -> dict:
        self.torch.cuda.synchronize()
        got = {k: v for c in self.counters for k, v in c.items()}
        self.by_path[path] = got
        say(f"  launches on the {path} path: {got}")
        for name in required:
            require(got[name] > 0, f"kernel {name} was not launched on the {path} path")
        return got


def start_server():
    from light_whisper_tpu_torch.runtime.qwen3_server import Qwen3EngineServer

    path, cfg = _flagship_path()
    engine = Qwen3EngineServer(engine="qwen3-asr-0.6b", device="cuda", model_path=path)
    client = PipeClient(engine.hooks())
    init = client.read()
    require(init.get("success") is True, f"init failed: {init}")
    require(init.get("backend") == "cuda", f"init backend {init.get('backend')!r}")
    say(f"  init: {init.get('message')} phases={engine._init_timings}")
    return engine, client, path, cfg


def _graph_spans() -> dict:
    """The decode loops' step, capture and replay counts so far."""
    from light_whisper_tpu_torch.runtime import tracing

    snap = tracing.snapshot()
    return {n: snap.get(n, {"count": 0})["count"] for n in ("model.decode.step", "model.decode.capture",
                                                             "model.decode.replay")}


def phase_slice(torch, engine, client, cfg, launches: Launches):
    import numpy as np

    from light_whisper_tpu_torch.eval.speechlike import speechlike

    launches.start()
    spans0 = _graph_spans()
    requests = (("speech 2 s", speechlike(2.0, seed=SEED), True),
                ("speech 12 s", speechlike(12.0, seed=SEED + 1), True),
                ("silence 3 s", np.zeros(3 * 16000, np.float32), False))
    step_ms = None
    for rid, (name, audio, speech) in enumerate(requests, start=1):
        reply = client.call(_transcribe_cmd(rid, audio))
        require(reply.get("success") is True, f"{name}: {reply}")
        require(reply.get("backend") == "cuda", f"{name}: backend {reply.get('backend')!r}")
        if speech:
            require(reply.get("vad_segments", 0) >= 1, f"{name}: no VAD segment: {reply}")
            steps = engine.model.last_decode_step_s
            med = _median_ms(steps)
            if name == "speech 12 s":
                step_ms, reply_12s = med, reply
            say(f"  {name}: inference_ms={reply['inference_ms']} vad_ms={reply['vad_ms']} "
                f"decode_steps={len(steps)} median_step_ms={med:.3f} text_chars={len(reply['text'])}")
        else:
            require(reply.get("vad_segments") == 0, f"{name}: expected no VAD segment: {reply}")
            say(f"  {name}: vad_segments=0 vad_ms={reply['vad_ms']}")
    # decode attention: the 2 s prompt's 64 rows; the batched attention: every B=1 decode step
    launches.read("slice", ["q8_matmul", "q8_matmul_stacked", "q8_matmul_stacked_fused", "decode_attention",
                            "decode_attention_batched"])
    graphs = {k: v - spans0.get(k, 0) for k, v in _graph_spans().items()}
    require(graphs["model.decode.capture"] == 2 and graphs["model.decode.replay"] == graphs["model.decode.step"] > 0,
            f"the slice's decode steps did not all replay a graph captured once a request: {graphs}")
    say(f"  decode graphs: {graphs['model.decode.capture']} captured, {graphs['model.decode.replay']} replays "
        f"for {graphs['model.decode.step']} steps")

    # the served model's prefill logits are finite and of the padded vocab width
    logits = engine.model.teacher_forced_logits(speechlike(2.0, seed=SEED), [1, 2])
    require(all(bool(torch.isfinite(l).all()) for l in logits), "non-finite flagship logits")
    require(logits[0].shape[-1] == 152_576, f"logits width {logits[0].shape[-1]}")
    say(f"phase slice: ok (0.6B width, {cfg.decoder.block_count} decoder layers, "
        f"{cfg.audio.block_count} encoder layers, decode {step_ms:.3f} ms/step median on 12 s)")
    return reply_12s


def _coalesced_round(client, name: str, clips, first_rid: int) -> None:
    """Write every request line at once; the first occupies the device for
    seconds, the others queue behind it and coalesce into one batch."""
    before = client.call({"action": "stats", "request_id": first_rid})["stats"]
    rids = list(range(first_rid + 1, first_rid + 1 + len(clips)))
    client.send(*(_transcribe_cmd(rid, clip) for rid, clip in zip(rids, clips)))
    replies = {}
    for _ in rids:
        reply = client.read()
        replies[reply.get("request_id")] = reply
    for rid in rids:
        reply = replies.get(rid, {})
        require(reply.get("success") is True and reply.get("vad_segments", 0) >= 1, f"{name} {rid}: {reply}")
    after = client.call({"action": "stats", "request_id": rids[-1] + 1})["stats"]
    dispatches = after["batch_dispatches"] - before["batch_dispatches"]
    batched = after["batched_requests"] - before["batched_requests"]
    say(f"  {name}: {len(clips)} concurrent requests -> batch_dispatches +{dispatches}, batched_requests "
        f"+{batched}; inference_ms {[replies[r]['inference_ms'] for r in rids]}")
    require(dispatches >= 1 and batched >= 2, f"{name}: requests did not coalesce ({dispatches}, {batched})")


def _divergence(model, clip, solo, other):
    """``None`` if the token lists agree; else the first step where they part
    and the top-2 logit gap of ``solo``'s path there."""
    if solo == other:
        return None
    step = next((i for i, (a, b) in enumerate(zip(solo, other)) if a != b), min(len(solo), len(other)))
    logits = model.teacher_forced_logits(clip, solo[:step])[step][: model.config.decoder.vocab_size]
    top2 = sorted(logits.tolist())[-2:]
    return step, top2[1] - top2[0]


def _first_divergence(model, clip, solo, batched) -> str:
    """Empty if the token lists agree; else where they part and the per-stream
    top-2 gap there, failing outside the 1e-3 tie band."""
    parted = _divergence(model, clip, solo, batched)
    if parted is None:
        return ""
    step, gap = parted
    require(gap <= TIE_BAND, f"batched tokens part from per-stream at step {step} with top-2 gap {gap:.3g}")
    return f"parts at step {step}, top-2 gap {gap:.3g} (tie)"


def phase_batch(torch, engine, client, launches: Launches):
    from light_whisper_tpu_torch.eval.speechlike import speechlike

    model = engine.model
    launches.start()
    # prompts of at most 64 rows (clips up to 3 s) reach the unstacked
    # attention kernel in the batched prefill; longer clips the plain softmax
    _coalesced_round(client, "round 2-3 s", [speechlike(s, seed=SEED + 30 + i)
                                              for i, s in enumerate((2.0, 2.5, 3.0, 2.2))], 100)
    _coalesced_round(client, "round 4-12 s", [speechlike(s, seed=SEED + 40 + i)
                                               for i, s in enumerate((12.0, 4.0, 6.5, 9.0))], 200)
    # the wire rounds alone must reach both batched attention kernels and the Q8 forms
    launches.read("batch", ["q8_matmul", "q8_matmul_stacked", "q8_matmul_stacked_fused",
                            "decode_attention_unstacked", "decode_attention_batched"])

    # model-level checks and the B sweep, counted apart from the wire path
    launches.start()
    keep = model.max_new_tokens
    try:
        model.max_new_tokens = 48
        clips = [speechlike(3.0, seed=SEED + 50 + i) for i in range(4)]  # one bucket: exactly 3.0 s
        batched = model.transcribe_batch(clips)
        for i, clip in enumerate(clips):
            solo = model.transcribe(clip).tokens
            note = _first_divergence(model, clip, solo, batched[i].tokens)
            say(f"  transcribe_batch vs transcribe, clip {i}: {len(solo)} tokens, "
                f"{note or 'identical'}")
        model.max_new_tokens = 64
        rates = {}
        for B in (1, 2, 4, 8):
            results = model.transcribe_batch([speechlike(3.0, seed=SEED + 60 + i) for i in range(B)])
            torch.cuda.synchronize()
            require(all(len(r.tokens) > 0 for r in results), f"B={B}: empty decode")
            ms = _median_ms(model.last_decode_step_s)
            rates[B] = (ms, B * 1000.0 / ms)
            say(f"  decode B={B} ({'transcribe' if B == 1 else 'transcribe_batch'}): {ms:.3f} ms/step median "
                f"over {len(model.last_decode_step_s)} steps, {rates[B][1]:.1f} tokens/s aggregate")
    finally:
        model.max_new_tokens = keep
    launches.read("batch-model", ["decode_attention_unstacked", "decode_attention_batched"])
    say("phase batch: ok " + json.dumps({f"B={B}": {"ms_per_step": ms, "tokens_per_s": tps}
                                          for B, (ms, tps) in rates.items()}))


def phase_longform(torch, client, launches: Launches):
    import numpy as np

    from light_whisper_tpu_torch.eval.speechlike import speechlike
    from light_whisper_tpu_torch.serving.longform import DEFAULT_MAX_WINDOW_SECONDS, DEFAULT_PAD_SECONDS

    pause = np.zeros(int(0.8 * 16000), np.float32)
    pieces = []
    for i, seconds in enumerate((20.0, 25.0, 18.0, 22.0, 24.0, 19.0, 23.0)):
        pieces += [speechlike(seconds, seed=SEED + 70 + i), pause]
    recording = np.concatenate(pieces)
    launches.start()
    t0 = time.perf_counter()
    reply = client.call(_transcribe_cmd(300, recording))
    wall = time.perf_counter() - t0
    require(reply.get("success") is True, f"long-form: {reply}")
    windows = reply.get("long_form_window_seconds") or []
    say(f"  {len(recording) / 16000:.1f} s recording: long_form={reply.get('long_form')} "
        f"vad_segments={reply.get('vad_segments')} windows={windows} vad_ms={reply.get('vad_ms')} "
        f"long_form_asr_ms={reply.get('long_form_asr_ms')} inference_ms={reply.get('inference_ms')} "
        f"wall {wall:.3f} s text_chars={len(reply.get('text', ''))}")
    require(reply.get("long_form") is True, "a 156 s request did not take the long-form path")
    require(reply.get("vad_segments", 0) >= 2, f"long-form windows: {reply.get('vad_segments')}")
    # a window holds at most the 28 s budget of speech, plus the 0.12 s
    # acoustic pad at each true segment edge (serving/longform.plan_windows)
    bound = DEFAULT_MAX_WINDOW_SECONDS + 2 * DEFAULT_PAD_SECONDS
    require(all(0 < w <= bound for w in windows), f"window over {bound} s: {windows}")
    launches.read("longform", ["decode_attention_batched", "q8_matmul", "q8_matmul_stacked",
                               "q8_matmul_stacked_fused"])
    say(f"phase longform: ok ({len(windows)} windows, max {max(windows)} s)")


def phase_single_pass(torch, engine, client, cfg, launches: Launches):
    """A 300 s recording decoded as one context (``long_form: false``)."""
    from light_whisper_tpu_torch.eval.speechlike import speechlike

    recording = speechlike(300.0, seed=SEED + 90)
    launches.start()
    t0 = time.perf_counter()
    reply = client.call(_transcribe_cmd(400, recording, long_form=False))
    wall = time.perf_counter() - t0
    require(reply.get("success") is True, f"single-pass: {reply}")
    steps = engine.model.last_decode_step_s
    say(f"  {len(recording) / 16000:.1f} s recording, long_form false: vad_segments={reply.get('vad_segments')} "
        f"speech_duration={reply.get('speech_duration')} vad_ms={reply.get('vad_ms')} "
        f"inference_ms={reply.get('inference_ms')} decode_steps={len(steps)} "
        f"median_step_ms={_median_ms(steps):.3f} wall {wall:.3f} s text_chars={len(reply.get('text', ''))}")
    require(not any(key.startswith("long_form") for key in reply), f"single-pass reply has long-form keys: {reply}")
    require(reply.get("vad_segments", 0) >= 1, f"single-pass: no VAD segment: {reply}")
    got = launches.read("single-pass", ["q8_matmul", "q8_matmul_stacked", "q8_matmul_stacked_fused",
                                        "decode_attention_batched", "flash_prefill"])
    layers = cfg.decoder.block_count
    require(got["flash_prefill"] == layers,
            f"flash_prefill launched {got['flash_prefill']} times; one prefill takes {layers}, one a layer")
    # the request's split, read on the model after the wire path: log-mel + encoder + prefill
    # of the same recording (a second run: the first one's allocations are warm)
    from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec

    model = engine.model
    prefill_ms = []
    for _ in range(2):
        request = model._prepare(recording)
        cache = dec.init_cache(cfg.decoder, 8192, model.cache_dtype, model.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model._encode_and_prefill(*request, cache)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1000)
        del cache
    say(f"  single-pass split: {len(request[2])} prompt rows; log-mel + encoder + prefill {prefill_ms[-1]:.3f} ms "
        f"(first {prefill_ms[0]:.3f} ms); decode {len(steps)} steps x {_median_ms(steps):.3f} ms median")
    say(f"phase single-pass: ok (one prefill at KV capacity 8192, flash_prefill x{layers}, "
        f"decode {_median_ms(steps):.3f} ms/step median)")


def phase_fused_ffn(torch, engine, client, cfg, launches: Launches, reply_12s: dict, rounds: int = 3):
    """The slice's 12 s request with ``LWT_FUSED_FFN=1``: every decode step's
    FFN halves go through ``fused_ffn_step``, one launch a layer. Sent
    ``rounds`` times with the route and as often without, alternating, for the
    decode ms/step of each (host noise between runs is larger than the gain)."""
    from light_whisper_tpu_torch.eval.speechlike import speechlike

    model = engine.model
    audio = speechlike(12.0, seed=SEED + 1)
    seen = []  # (route, audio the model got, tokens, decode steps) of each request
    real_transcribe = model.transcribe

    def spy(clip):
        result = real_transcribe(clip)
        seen.append((os.environ.get("LWT_FUSED_FFN"), clip, result.tokens, len(model.last_decode_step_s)))
        return result

    step_ms = {"off": [], "on": []}
    texts = {"off": set(), "on": set()}
    model.transcribe = spy
    launches.start()
    try:
        for rnd in range(rounds):
            for route in ("off", "on"):
                if route == "on":
                    os.environ["LWT_FUSED_FFN"] = "1"
                try:
                    reply = client.call(_transcribe_cmd(500 + 2 * rnd + (route == "on"), audio))
                finally:
                    os.environ.pop("LWT_FUSED_FFN", None)
                require(reply.get("success") is True and reply.get("backend") == "cuda", f"fused-ffn {route}: {reply}")
                missing = sorted(set(reply_12s) - set(reply))
                require(not missing, f"fused-ffn {route}: the reply lacks {missing}")
                step_ms[route].append(_median_ms(model.last_decode_step_s))
                texts[route].add(reply.get("text"))
    finally:
        del model.transcribe  # the instance attribute; the class method again
    got = launches.read("fused-ffn", ["fused_ffn_step", "q8_matmul", "q8_matmul_stacked", "q8_matmul_stacked_fused",
                                      "decode_attention"])
    require(len(seen) == 2 * rounds, f"the model ran {len(seen)} transcribes for {2 * rounds} requests")
    on_forwards = sum(steps for route, _clip, _tokens, steps in seen if route)
    layers = cfg.decoder.block_count
    require(got["fused_ffn_step"] == layers * on_forwards,
            f"fused_ffn_step launched {got['fused_ffn_step']} times; {on_forwards} routed decode forwards "
            f"x {layers} layers make {layers * on_forwards}")
    _route, clip, off_tokens, _steps = seen[0]
    on_tokens = seen[1][2]
    require(all(t == off_tokens for route, _c, t, _s in seen if not route), "the unrouted replies differ run to run")
    require(all(t == on_tokens for route, _c, t, _s in seen if route), "the routed replies differ run to run")
    parted = _divergence(model, clip, off_tokens, on_tokens)
    note = ("identical tokens" if parted is None
            else f"first differs at token {parted[0]}, unrouted top-2 gap there {parted[1]:.3g}")
    say(f"  fused-ffn vs the slice's 12 s reply: {len(on_tokens)} vs {len(off_tokens)} tokens, {note}; text "
        f"identical to the slice's: unrouted {texts['off'] == {reply_12s.get('text')}}, "
        f"routed {texts['on'] == {reply_12s.get('text')}}")
    say(f"  decode ms/step (median of each request's steps), alternating off/on x{rounds}: "
        f"off {[round(v, 3) for v in step_ms['off']]} on {[round(v, 3) for v in step_ms['on']]}")
    off, on = sorted(step_ms["off"])[rounds // 2], sorted(step_ms["on"])[rounds // 2]
    say(f"phase fused-ffn: ok (fused_ffn_step x{got['fused_ffn_step']} = {layers} x {on_forwards} decode forwards; "
        f"decode {off:.3f} ms/step without the route, {on:.3f} with it, medians of {rounds})")


INTERIM_BUDGET = 96  # the reference's INTERIM_MAX_NEW_TOKENS: random weights never emit EOS


def _session(engine, stream):
    return engine._session_pool._bridges[stream]._inc


def _tick_counts(inc):
    return (inc.full_prefills, inc.incremental_prefills, inc.draft_tokens_offered, inc.draft_tokens_accepted)


def phase_interim(torch, engine, client, launches: Launches):
    """The app's interim loop on named streams, session reuse on: one stream
    ticking at 3, 4, ..., 9 s of one recording; then two streams whose ticks
    are written at once while a job holds the device, so that they coalesce
    into batched ticks (fresh, then extending), replayed one at a time on two
    new streams.
    The decode budget is ``INTERIM_BUDGET`` (the model's is restored after)."""
    import numpy as np

    from light_whisper_tpu_torch.eval.speechlike import speechlike
    from light_whisper_tpu_torch.serving.incremental import IncrementalTranscriber

    model = engine.model
    keep = model.max_new_tokens
    model.max_new_tokens = INTERIM_BUDGET
    recording = np.concatenate([np.zeros(4800, np.float32), speechlike(9.0, seed=SEED + 100)])
    windows = [recording[: 4800 + s * 16000] for s in range(3, 10)]
    pair = [speechlike(5.0, seed=SEED + 101), speechlike(5.0, seed=SEED + 102)]
    rid = 600
    t0 = time.perf_counter()
    # what each single request handed the model: (session key, trimmed audio, tokens)
    calls = []
    real_transcribe_model = engine._transcribe_model

    def spy(audio, session_key):
        result = real_transcribe_model(audio, session_key)
        calls.append((session_key, np.array(audio), list(result.tokens)))
        return result

    engine._transcribe_model = spy
    try:
        launches.start()
        ticks = []
        for window in windows:
            rid += 1
            pool = engine._session_pool  # made by the first request with sessions on
            bridge = pool._bridges.get("interim") if pool else None
            before = _tick_counts(bridge._inc) if bridge else (0, 0, 0, 0)
            reply = client.call(_transcribe_cmd(rid, window, stream="interim"))
            require(reply.get("success") is True and reply.get("backend") == "cuda", f"interim tick {rid}: {reply}")
            inc = _session(engine, "interim")
            after = _tick_counts(inc)
            ticks.append((len(window) / 16000, reply, [a - b for a, b in zip(after, before)],
                          len(inc.last_decode_step_s)))
        incremental = inc.incremental_prefills  # read now: later streams may evict this session

        def coalesced(streams, clips):
            """The ticks written at once while a job holds the device: they
            queue together and run as one batch when it lets go."""
            nonlocal rid
            rids = list(range(rid + 1, rid + 1 + len(clips)))
            rid = rids[-1]
            scheduler = engine._decode_scheduler()
            running, release = threading.Event(), threading.Event()
            scheduler.submit("interim-hold", lambda: (running.set(), release.wait(60)), supersede=False)
            try:
                require(running.wait(60), "the scheduler did not start the holding job")
                client.send(*(_transcribe_cmd(r, clip, stream=s) for r, clip, s in zip(rids, clips, streams)))
                deadline = time.monotonic() + 60
                while len(scheduler._queue) < len(clips) and time.monotonic() < deadline:
                    time.sleep(0.002)
                require(len(scheduler._queue) == len(clips), f"{len(scheduler._queue)} ticks queued of {len(clips)}")
            finally:
                release.set()
            replies = {}
            for _ in rids:
                reply = client.read()
                replies[reply.get("request_id")] = reply
            for r in rids:
                require(replies[r].get("success") is True, f"coalesced tick {r}: {replies[r]}")
            return [replies[r] for r in rids]

        rounds = [[clip[: int(s * 16000)] for clip in pair] for s in (3.0, 4.0, 5.0)]
        before = client.call({"action": "stats", "request_id": rid + 1})["stats"]["batched_tick_dispatches"]
        rid += 1
        batched = [coalesced(["tick-a", "tick-b"], clips) for clips in rounds]
        got = launches.read("interim", ["q8_matmul", "q8_matmul_stacked", "q8_matmul_stacked_fused",
                                        "decode_attention", "decode_attention_batched"])
        stats = client.call({"action": "stats", "request_id": rid + 1})["stats"]
        rid += 1

        # the same windows stateless, for the time beside each tick; where the
        # texts differ on the same trimmed bytes, where the tokens part and
        # the stateless top-2 gap there (the tick's session rows come from
        # other programs, at another capacity: its tokens may part from the
        # stateless ones at a near-tie, as the reference's do)
        tick_calls = [c for c in calls if c[0] == "interim"]
        del calls[:]
        for k, (seconds, reply, (full, incr, offered, accepted), steps) in enumerate(ticks):
            os.environ["LIGHT_WHISPER_DISABLE_SESSION_REUSE"] = "1"
            try:
                rid += 1
                plain = client.call(_transcribe_cmd(rid, recording[: int(seconds * 16000)]))
            finally:
                os.environ.pop("LIGHT_WHISPER_DISABLE_SESSION_REUSE", None)
            require(plain.get("success") is True, f"stateless {seconds} s: {plain}")
            note = ""
            if plain["text"] != reply["text"]:
                _key, tick_audio, tick_tokens = tick_calls[k]
                _key, plain_audio, plain_tokens = calls[-1]
                if np.array_equal(tick_audio, plain_audio):
                    parted = _divergence(model, plain_audio, plain_tokens, tick_tokens)
                    note = (f" (text differs on the same trimmed bytes: parts at token {parted[0]}, stateless "
                            f"top-2 gap {parted[1]:.3g}, {'inside' if parted[1] <= TIE_BAND else 'outside'} "
                            f"the {TIE_BAND:g} tie band)" if parted else " (text differs, tokens equal)")
                else:
                    note = (f" (text differs: trimmed to {len(tick_audio)} samples, stateless "
                            f"{len(plain_audio)})")
            say(f"  tick {seconds:.1f} s: inference_ms={reply['inference_ms']} vad_ms={reply['vad_ms']} "
                f"{'incremental' if incr else 'full'} prefill, draft {accepted}/{offered} accepted, "
                f"decode_steps={steps}; stateless inference_ms={plain['inference_ms']} vad_ms={plain['vad_ms']}"
                f"{note}")

        # the coalesced ticks one at a time, on two new streams
        for k, clips in enumerate(rounds):
            for i, (clip, stream) in enumerate(zip(clips, ("solo-a", "solo-b"))):
                rid += 1
                solo = client.call(_transcribe_cmd(rid, clip, stream=stream))
                require(solo.get("text") == batched[k][i].get("text"),
                        f"coalesced tick {k} of stream {i}: {batched[k][i].get('text')!r} != one at a time "
                        f"{solo.get('text')!r}")
        say(f"  coalesced ticks: 3 rounds of 2 streams, replies equal to the same ticks one at a time; "
            f"inference_ms {[[r['inference_ms'] for r in rnd] for rnd in batched]}")

        say(f"  session stats: hits={stats['session_hits']} resets={stats['session_resets']} "
            f"vad_prefix_reuse={stats['vad_prefix_reuse']} batched_tick_dispatches={stats['batched_tick_dispatches']} "
            f"batched_tick_degrades={stats['batched_tick_degrades']} speculative={stats['speculative_decoding']}")
        require(stats["session_streams"]["interim"]["hits"] >= 6,
                f"interim stream: {stats['session_streams']['interim']} (>= 6 hits)")
        require(incremental >= 1, "no incremental prefill on the interim stream")
        require(stats["vad_prefix_reuse"] >= 1, "no VAD prefix reuse")
        require(stats["batched_tick_dispatches"] - before == len(rounds),
                f"{stats['batched_tick_dispatches'] - before} batched tick dispatches for {len(rounds)} rounds")
        require(stats["batched_tick_degrades"] == 0,
                f"batched ticks degraded: {stats['batched_tick_degrades']} ({stats['batched_tick_last_error']})")

        # tick against stateless on the model, under the narrow gate's rule
        inc = IncrementalTranscriber(model, max_new_tokens=INTERIM_BUDGET)
        for seconds in (3, 5, 7, 9):
            clip = recording[: seconds * 16000]
            tick = inc.transcribe_window(clip).tokens
            if seconds == 3:
                continue  # the first tick is a full prefill
            stateless = model.transcribe(clip).tokens
            parted = _divergence(model, clip, stateless, tick)
            verdict = narrow_verdict(stateless, tick, [parted] if parted else [])
            say(f"  model-level tick {seconds} s vs stateless transcribe: {len(tick)} tokens, "
                f"{'identical' if parted is None else f'first differs at {parted[0]}, top-2 gap {parted[1]:.3g}'}")
            require(verdict is None, f"tick {seconds} s: {verdict}")
        require(inc.incremental_prefills == 3, f"model-level ticks: {inc.incremental_prefills} incremental")
    finally:
        model.max_new_tokens = keep
        del engine._transcribe_model  # the instance attribute; the class method again
    say(f"phase interim: ok in {time.perf_counter() - t0:.1f} s ({len(windows)} ticks on one stream, "
        f"{incremental} incremental; "
        f"{stats['batched_tick_dispatches']} batched tick dispatches; launches "
        f"{ {k: got[k] for k in ('q8_matmul', 'q8_matmul_stacked', 'q8_matmul_stacked_fused', 'decode_attention', 'decode_attention_batched')} })")


# ---------------------------------------------------------------------------
# phase dictate: engine_cli's dictation loop on the served model

DICTATE_SECONDS = 12.0
INTERIM_FIELDS = ["event", "stable", "tentative", "covered_samples", "tick_ms"]
FINAL_FIELDS = ["event", "text", "language", "duration_seconds", "from_interim_cache", "interim_ticks", "asr_ms",
                "too_short"]


def check_dictation(events, seconds: float):
    """(interim events, the final event) of one dictation, after the schema
    checks: the reference's event names and fields, one ``final`` event last,
    its duration within 0.01 s of ``seconds`` and not too short."""
    require(bool(events) and events[-1].get("event") == "final", f"dictation ended without a final event: {events}")
    *interims, final = events
    for event in interims:
        require(list(event) == INTERIM_FIELDS and event["event"] == "interim", f"interim event {event}")
    require(list(final) == FINAL_FIELDS, f"final event fields {list(final)}")
    require(abs(final["duration_seconds"] - seconds) <= 0.01 and final["too_short"] is False,
            f"final event {final} for {seconds} s of audio")
    require(final["interim_ticks"] == len(interims), f"{final['interim_ticks']} ticks, {len(interims)} events")
    return interims, final


def phase_dictate(torch, engine, launches: Launches):
    """``engine_cli``'s dictation loop (``dictate``) in-process on the served
    0.6B model: a 12 s speech-like clip in 250 ms blocks paced in real time,
    interim ticks on the recording controller's own thread, then finalize. The
    final text is held against a fresh ``IncrementalTranscriber`` of the clip
    as the session heard it (through the capture ring's int16) under
    ``narrow_verdict``, or, from the interim cache, against the last tick."""
    import numpy as np

    from light_whisper_tpu_torch.audio.capture import mix_to_mono
    from light_whisper_tpu_torch.eval.speechlike import speechlike
    from light_whisper_tpu_torch.runtime.engine_cli import dictate
    from light_whisper_tpu_torch.serving.incremental import IncrementalTranscriber

    model = engine.model
    clip = speechlike(DICTATE_SECONDS, seed=SEED + 200)
    events, steps = [], []
    inc = IncrementalTranscriber(model)

    def emit(kind, **payload):
        if kind == "interim":  # on the interim thread, before its next tick
            steps.append((len(inc.last_decode_step_s), _median_ms(inc.last_decode_step_s)))
        events.append({"event": kind, **payload})

    t0 = time.perf_counter()
    launches.start()
    dictate(model, clip, emit, realtime=True, transcriber=inc)
    wall = time.perf_counter() - t0
    got = launches.read("dictate", ["q8_matmul", "q8_matmul_stacked", "q8_matmul_stacked_fused",
                                    "decode_attention_batched"])  # after the controller joined its thread
    require(got["fused_ffn_step"] == 0, f"fused_ffn_step launched {got['fused_ffn_step']} times on the dictate path")
    interims, final = check_dictation(events, DICTATE_SECONDS)
    require(len(interims) >= 1, f"no interim event in a {DICTATE_SECONDS:g} s dictation")
    for event, (n, med) in zip(interims, steps):
        say(f"  interim: covered {event['covered_samples'] / 16000:.2f} s, tick_ms={event['tick_ms']}, "
            f"stable {len(event['stable'])} chars, tentative {len(event['tentative'])} chars; "
            f"{n} decode steps, median {med:.3f} ms")
    say(f"  session: {inc.full_prefills} full and {inc.incremental_prefills} incremental prefills, draft "
        f"{inc.draft_tokens_accepted}/{inc.draft_tokens_offered} tokens accepted; the final's call decoded "
        f"{len(inc.last_decode_step_s)} steps, median {_median_ms(inc.last_decode_step_s):.3f} ms")

    # a fresh transcribe of what the capture ring handed the session, on this
    # (the main) thread: the final's reference, and a control of the step time
    heard = mix_to_mono(clip).astype(np.float32) / 32768.0
    fresh_inc = IncrementalTranscriber(model)
    fresh = fresh_inc.transcribe(heard)
    say(f"  fresh transcribe on the main thread: {len(fresh_inc.last_decode_step_s)} decode steps, median "
        f"{_median_ms(fresh_inc.last_decode_step_s):.3f} ms")
    if final["from_interim_cache"]:
        last = interims[-1]["stable"] + interims[-1]["tentative"]
        require(final["text"] == last, "final text from the interim cache is not the last tick's text")
        note = "the last tick's text"
    else:
        parted = _divergence(model, heard, fresh.tokens, inc._last_generated)
        verdict = narrow_verdict(fresh.tokens, inc._last_generated, [parted] if parted else [])
        note = ("a fresh transcribe's tokens, identical" if parted is None else
                f"a fresh transcribe's tokens up to token {parted[0]}, top-2 gap {parted[1]:.3g}")
        require(verdict is None, f"dictate final vs a fresh transcribe: {verdict}")
        require(parted is not None or final["text"] == fresh.text, "equal tokens, other text")
    ticks = sorted(e["tick_ms"] for e in interims)
    say(f"phase dictate: ok in {wall:.1f} s ({len(interims)} ticks on {DICTATE_SECONDS:g} s, "
        f"tick_ms p50 {ticks[len(ticks) // 2]} max {ticks[-1]}; final asr_ms {final['asr_ms']}, "
        f"from_interim_cache {final['from_interim_cache']}, held to {note}; launches {got})")


# ---------------------------------------------------------------------------
# phase precise: LIGHT_WHISPER_PRECISE=1 through the wire loop


def f32_matmul_error(torch) -> float:
    """A 1024 x 1024 x 1024 f32 matmul on the card against float64 on the host:
    max|err| / max|product|, about 1e-6 in f32 and about 1e-3 with TF32's
    10-bit mantissa. Fails above 1e-5, or when the flags allow TF32."""
    require(not torch.backends.cuda.matmul.allow_tf32 and torch.get_float32_matmul_precision() == "highest",
            f"TF32 allowed for f32 matmuls ({torch.get_float32_matmul_precision()})")
    gen = torch.Generator().manual_seed(SEED)
    a, b = (torch.randn(1024, 1024, generator=gen, dtype=torch.float64) for _ in range(2))
    want = a.float().double() @ b.float().double()
    got = (a.float().cuda() @ b.float().cuda()).double().cpu()
    err = float((got - want).abs().max() / want.abs().max())
    require(err <= 1e-5, f"f32 matmul on the card is {err:.3g} off float64: not full f32")
    return err


def phase_precise(torch, model_path: str, launches: Launches):
    """The 0.6B artifact served with ``LIGHT_WHISPER_PRECISE=1`` (dense f32
    weights, f32 compute, f32 KV cache; sessions on, as served): the 2 s and
    12 s requests of ``slice``, no kernel launched, every KV cache f32. Then
    the narrow model in precise mode on the card and on the CPU."""
    from light_whisper_tpu_torch.eval.speechlike import speechlike
    from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec
    from light_whisper_tpu_torch.runtime.qwen3_server import Qwen3EngineServer

    err = f32_matmul_error(torch)
    say(f"  f32 matmul on the card: max|err|/max|product| {err:.3g} against float64 (TF32 would give ~1e-3)")
    cache_dtypes = []
    real_init_cache = dec.init_cache

    def init_cache(*args, **kwargs):
        cache = real_init_cache(*args, **kwargs)
        cache_dtypes.append(cache.k.dtype)
        return cache

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    os.environ["LIGHT_WHISPER_PRECISE"] = "1"
    dec.init_cache = init_cache
    launches.start()
    t0 = time.perf_counter()
    try:
        engine = Qwen3EngineServer(engine="qwen3-asr-0.6b", device="cuda", model_path=model_path)
        client = PipeClient(engine.hooks())
        try:
            init = client.read()
            require(init.get("success") is True, f"precise init failed: {init}")
            model = engine.model
            require(model.cache_dtype == torch.float32 and model.config.decoder.compute_dtype == "float32",
                    f"precise model: cache {model.cache_dtype}, compute {model.config.decoder.compute_dtype}")
            say(f"  precise init in {time.perf_counter() - t0:.1f} s: phases={engine._init_timings}")
            for rid, (name, audio) in enumerate((("speech 2 s", speechlike(2.0, seed=SEED)),
                                                 ("speech 12 s", speechlike(12.0, seed=SEED + 1))), start=1):
                reply = client.call(_transcribe_cmd(rid, audio))
                require(reply.get("success") is True and reply.get("vad_segments", 0) >= 1, f"precise {name}: {reply}")
                steps = model.last_decode_step_s
                say(f"  precise {name}: inference_ms={reply['inference_ms']} vad_ms={reply['vad_ms']} "
                    f"decode_steps={len(steps)} median_step_ms={_median_ms(steps):.3f} text_chars={len(reply['text'])}")
            bye = client.call({"action": "exit", "request_id": 9})
            require(bye.get("success") is True, f"precise exit: {bye}")
        finally:
            client.close()
    finally:
        dec.init_cache = real_init_cache
        os.environ.pop("LIGHT_WHISPER_PRECISE", None)
    got = launches.read("precise", [])
    require(not any(got.values()), f"precise mode launched kernels: { {k: v for k, v in got.items() if v} }")
    require(cache_dtypes and set(cache_dtypes) == {torch.float32}, f"precise KV caches {cache_dtypes}")
    peak = torch.cuda.max_memory_allocated() - base
    del engine, model
    torch.cuda.empty_cache()
    _cfg, path = narrow_model()
    card_vs_cpu(torch, path, "narrow precise", precise=True, tol=1e-4)
    say(f"phase precise: ok (f32 weights, compute and KV cache: {len(cache_dtypes)} caches; no kernel launched; "
        f"peak memory {peak / 2**30:.3f} GiB over the {base / 2**30:.3f} GiB held before; "
        f"{time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# phase train: the fine-tuning step on the card


def training_params(tree, owner: str = ""):
    """A dense f32 tree as training holds it: bf16 linear and embedding
    matrices (``w`` of two or three dimensions outside a norm), f32 norms,
    biases, convolutions and positions (the dtypes of
    ``__graft_entry__._random_params``)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = training_params(value, key)
        elif key == "w" and value.dim() in (2, 3) and not (owner.endswith("norm") or owner == "ln_post"):
            out[key] = value.bfloat16()
        else:
            out[key] = value
    return out


def train_batch(torch, cfg, prefix_ids, suffix_ids, batch: int, seconds: float, labels: int, seed: int):
    """``batch`` speech-like clips as whole chunks of log-mel, prompts with the
    audio placeholders, and ``labels`` random transcript tokens to predict."""
    import numpy as np

    from light_whisper_tpu_torch.audio.mel import log_mel
    from light_whisper_tpu_torch.eval.speechlike import speechlike
    from light_whisper_tpu_torch.parallel.train import IGNORE_LABEL

    clips = np.stack([speechlike(seconds, seed=seed + i) for i in range(batch)])
    mel = log_mel(torch.from_numpy(clips))
    chunks = mel.shape[1] // cfg.audio.chunk_frames
    mel = mel[:, : chunks * cfg.audio.chunk_frames]
    prompt = list(prefix_ids) + [cfg.audio_token_id] * (chunks * cfg.audio.tokens_per_chunk) + list(suffix_ids)
    rng = np.random.default_rng(seed)
    ids = np.zeros((batch, len(prompt) + labels), np.int64)
    ids[:, : len(prompt)] = prompt
    ids[:, len(prompt):] = rng.integers(0, min(cfg.decoder.vocab_size, cfg.audio_token_id) - 8, (batch, labels))
    targets = np.full_like(ids, IGNORE_LABEL)
    targets[:, len(prompt) - 1 : -1] = ids[:, len(prompt):]
    return mel, torch.from_numpy(ids), torch.from_numpy(targets)


def _dense_trees(path: str):
    """(config, prefix ids, suffix ids, encoder tree, decoder tree) of the
    GGUF at ``path`` loaded as the precise loader does (dense f32, host)."""
    from light_whisper_tpu_torch.models.qwen3_asr.loader import Qwen3ASRWeights
    from light_whisper_tpu_torch.models.qwen3_asr.prompt import resolve_prompt_ids

    w = Qwen3ASRWeights(path, device="cpu", precise=True)
    prefix, suffix = resolve_prompt_ids(w.metadata.get("tokenizer.chat_template"), w.tokenizer,
                                        w.config.audio_token_id)
    return w.config, prefix, suffix, w.encoder_params, w.decoder_params


@contextlib.contextmanager
def nccl_mesh(torch):
    """A one-rank NCCL process group over a ``FileStore`` and its dp1 x tp1
    mesh, torn down on exit."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from light_whisper_tpu_torch.parallel import mesh as pmesh

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix="lwt-nccl-store-", dir=os.path.join(REPO, "build"))
    pmesh.init_distributed("cuda", 0, 1, store=dist.FileStore(os.path.join(store_dir, "store"), 1), timeout_s=120)
    try:
        mesh = pmesh.make_mesh(1, 1, device_type="cuda")
        require(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        yield mesh
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)


def phase_train(torch, model_path: str, launches: Launches, steps: int = 5, profile_dir=None):
    """(a) one train step of the narrow model in f32 on the card and on the
    CPU from the same parameters and batch; (b) ``steps`` steps at the 0.6B
    widths (bf16 matrices) through a dp1 x tp1 mesh on NCCL (with
    ``profile_dir``, two more, the second under torch.profiler), and a
    checkpoint of that state saved and restored bitwise."""
    import shutil

    from light_whisper_tpu_torch.models.qwen3_asr.params import numpy_from_params
    from light_whisper_tpu_torch.parallel import checkpoint, train

    t_phase = time.perf_counter()
    launches.start()
    # (a) f32, so that TF32 anywhere in the forward or the backward (about
    # 5e-4 relative) stands far above f32's rounding (about 1e-6)
    _cfg, path = narrow_model()
    cfg, prefix, suffix, enc, dec_p = _dense_trees(path)
    cfg = cfg.with_compute_dtype("float32")
    batch = train_batch(torch, cfg, prefix, suffix, batch=2, seconds=2.0, labels=8, seed=SEED + 100)
    result = {}
    for where in ("cpu", "cuda"):
        state = train.init_state(None, enc, dec_p, train.adam(1e-3), cfg, device=where)
        step, place = train.make_train_step(cfg, None, len(prefix), device=where)
        state, loss = step(state, *place(*batch))
        result[where] = (float(loss), train.tree_leaves(numpy_from_params(
            train.tree_map(state.params, lambda p: p.grad))))
    (loss_cpu, g_cpu), (loss_card, g_card) = result["cpu"], result["cuda"]
    rel_loss = abs(loss_card - loss_cpu) / abs(loss_cpu)

    def l2(a):
        return float((a.astype("float64") ** 2).sum()) ** 0.5

    # a leaf's gradient under 1e-3 of the whole gradient's norm is held to
    # that norm: the encoder's k bias has a zero gradient in exact arithmetic
    floor = 1e-3 * sum(l2(g) ** 2 for g in g_cpu) ** 0.5
    worst = max((l2(a.astype("float64") - b) / max(l2(b), floor), i, b.shape)
                for i, (a, b) in enumerate(zip(g_card, g_cpu)))
    say(f"  train narrow f32: loss card {loss_card:.7f} CPU {loss_cpu:.7f} (rel {rel_loss:.3g}, tol 1e-5); "
        f"worst gradient rel L2 {worst[0]:.3g} at leaf {worst[1]} {tuple(worst[2])} of {len(g_cpu)} (tol 1e-4)")
    require(rel_loss <= 1e-5, f"narrow train loss card vs CPU {rel_loss:.3g}")
    require(worst[0] <= 1e-4, f"narrow train gradient card vs CPU {worst[0]:.3g} at leaf {worst[1]}")

    # (b) the 0.6B widths
    cfg, prefix, suffix, enc, dec_p = _dense_trees(model_path)
    enc, dec_p = training_params(enc), training_params(dec_p)
    B, seconds, n_labels = 4, 10.0, 48
    mel, ids, labels = train_batch(torch, cfg, prefix, suffix, batch=B, seconds=seconds, labels=n_labels,
                                   seed=SEED + 200)
    ckpt = os.path.join(REPO, "build", "chip_smoke", "train-ckpt")
    stack = contextlib.ExitStack()
    try:
        mesh = stack.enter_context(nccl_mesh(torch))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        state = train.init_state(mesh, enc, dec_p, train.adam(1e-3), cfg)
        step, place = train.make_train_step(cfg, mesh, len(prefix))
        placed = place(mel, ids, labels)
        losses, walls = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, *placed)
            losses.append(float(loss))  # synchronises
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() - base
        rows = B * ids.shape[1]
        ms = sorted(walls[1:])[len(walls[1:]) // 2] * 1000
        say(f"  train 0.6B: B={B} x {mel.shape[1]} mel frames ({ids.shape[1]} rows, {n_labels} labels each); "
            f"losses {[round(v, 4) for v in losses]}; step ms {[round(w * 1000, 3) for w in walls]} "
            f"(median after the first {ms:.3f}); {rows * 1000 / ms:.1f} tokens/s ({B * n_labels * 1000 / ms:.1f} "
            f"label tokens/s); peak memory {peak / 2**30:.3f} GiB over the {base / 2**30:.3f} GiB held before")
        require(all(v == v and abs(v) != float("inf") for v in losses), f"non-finite loss: {losses}")
        require(losses[-1] < losses[0], f"loss did not fall over {steps} steps: {losses}")
        got = launches.read("train", [])
        require(not any(got.values()), f"the train step launched kernels: { {k: v for k, v in got.items() if v} }")
        if profile_dir:
            profile_run(torch, "train", f"0.6B train step, B={B} x {seconds:g} s, {n_labels} labels each",
                        lambda: step(state, *placed), profile_dir)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_train_state(ckpt, state)
        save_s = time.perf_counter() - t0
        template = train.init_state(mesh, enc, dec_p, train.adam(1e-3), cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = checkpoint.restore_train_state(ckpt, template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
        require(checkpoint.tree_equal(restored, state), "the restored 0.6B train state differs from the saved one")
        say(f"  checkpoint of the 0.6B state ({size / 2**30:.3f} GiB): save {save_s:.3f} s, restore {restore_s:.3f} s, "
            f"bitwise equal after step {restored.step}")
    finally:
        stack.close()
        shutil.rmtree(ckpt, ignore_errors=True)
    del state, template, restored
    torch.cuda.empty_cache()
    say(f"phase train: ok (narrow f32 card = CPU; 0.6B {steps} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"{ms:.3f} ms/step; no kernel launched; {time.perf_counter() - t_phase:.1f} s)")


MESH_BUDGET = 128  # decode budget of phase mesh's requests: ms/step over 127 steps, the phase under ~90 s


def _mesh_verdict(plain, meshed, audio, ref, got, label: str) -> str:
    """``narrow_verdict`` of the meshed model's tokens against the unmeshed
    model's: where they differ, the steps whose teacher-forced argmax
    (along the unmeshed tokens) differs between the two models, each with the
    unmeshed top-2 gap, must be ties, and the tokens equal before the first."""
    if got == ref:
        return "identical"
    want = plain.teacher_forced_logits(audio, ref)
    have = meshed.teacher_forced_logits(audio, ref)
    vocab = plain.config.decoder.vocab_size
    flips = []
    for step, (a, b) in enumerate(zip(want, have)):
        if int(a[:vocab].argmax()) != int(b[:vocab].argmax()):
            top2 = a[:vocab].topk(2).values
            flips.append((step, float(top2[0] - top2[1])))
    verdict = narrow_verdict(ref, got, flips)
    require(verdict is None, f"mesh {label}: {verdict}")
    return f"parts at step {min(s for s, _ in flips)}, flips {flips} (ties)"


def phase_mesh(torch, model_path: str, launches: Launches, profile_dir=None):
    """The served 0.6B artifact as ``Qwen3ASRModel(mesh=)`` on a one-rank NCCL
    group (dp1 x tp1): the tensor-parallel route (o/down partials summed,
    then the residual; no fused FFN even with ``LWT_FUSED_FFN=1``) and the
    sessions' cache placement, held against the unmeshed model on the same
    inputs: the 12 s clip, a fresh then an extending tick, a batch of four,
    the dp-split batch at dp=1; then ``encode_chunks_sp`` at sp=1 on the
    300 s clip's mel against ``encode_chunks``. With ``profile_dir``, the
    12 s clip meshed and unmeshed under torch.profiler, 32 decode steps each."""
    from light_whisper_tpu_torch.audio import mel as wmel
    from light_whisper_tpu_torch.eval.speechlike import speechlike
    from light_whisper_tpu_torch.models.qwen3_asr.encoder import encode_chunks
    from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel
    from light_whisper_tpu_torch.parallel import dryrun, encoder_sp
    from light_whisper_tpu_torch.serving.incremental import IncrementalTranscriber

    t_phase = time.perf_counter()
    clip = speechlike(12.0, seed=SEED + 1)
    recording = speechlike(9.0, seed=SEED + 110)
    windows = (recording[: 6 * 16000], recording)  # 6 s then 9 s: one window group stable, a draft to verify
    clips = [speechlike(3.0, seed=SEED + 50 + i) for i in range(4)]

    def drive(model, split=None):
        out = {"transcribe": model.transcribe(clip).tokens, "step_ms": _median_ms(model.last_decode_step_s)}
        keep = model.max_new_tokens
        model.max_new_tokens = INTERIM_BUDGET
        try:
            inc = IncrementalTranscriber(model, max_new_tokens=INTERIM_BUDGET)
            out["ticks"] = [inc.transcribe_window(w, 0).tokens for w in windows]
            out["tick_counts"] = _tick_counts(inc)
        finally:
            model.max_new_tokens = keep
        out["batch"] = [r.tokens for r in model.transcribe_batch(clips)]
        if split is not None:
            out["dp"] = [r.tokens for r in dryrun.transcribe_batch_dp(model, clips, split)]
        return out

    plain = Qwen3ASRModel(model_path, device="cuda", max_new_tokens=MESH_BUDGET)
    want = drive(plain)
    with nccl_mesh(torch) as mesh:
        meshed = Qwen3ASRModel(model_path, max_new_tokens=MESH_BUDGET, mesh=mesh)
        require(meshed.device.type == "cuda" and meshed.rank_config == plain.config, "a dp1 x tp1 mesh changes widths")
        launches.start()
        os.environ["LWT_FUSED_FFN"] = "1"  # off under a mesh whatever it says
        try:
            got = drive(meshed, mesh)
        finally:
            os.environ.pop("LWT_FUSED_FFN", None)
        counts = launches.read("mesh", ["q8_matmul", "q8_matmul_stacked", "q8_matmul_stacked_fused",
                                        "decode_attention_batched"])
        require(counts["fused_ffn_step"] == 0, f"fused_ffn_step launched {counts['fused_ffn_step']} times under a mesh")
        require(got["tick_counts"][1] >= 1, f"the extending tick did not extend: {got['tick_counts']}")

        say(f"  transcribe 12 s: {len(got['transcribe'])} tokens, "
            f"{_mesh_verdict(plain, meshed, clip, want['transcribe'], got['transcribe'], 'transcribe')}; decode "
            f"{got['step_ms']:.3f} ms/step meshed vs {want['step_ms']:.3f} unmeshed (median of "
            f"{MESH_BUDGET - 1} steps)")
        for name, window, a, b in zip(("fresh", "extending"), windows, want["ticks"], got["ticks"]):
            say(f"  tick {name} ({len(window) / 16000:.0f} s): {len(b)} tokens, "
                f"{_mesh_verdict(plain, meshed, window, a, b, f'tick {name}')}")
        say(f"  tick counters (full, incremental prefills, draft offered, accepted): meshed {got['tick_counts']}, "
            f"unmeshed {want['tick_counts']}")
        # what a decode step's row-parallel sums cost: o and down, one all-reduce each a layer
        row = torch.zeros((1, plain.config.decoder.embedding_length), device="cuda")
        calls = 2 * plain.config.decoder.block_count * 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            meshed.tp.reduce(row)
        torch.cuda.synchronize()
        per_ms = (time.perf_counter() - t0) * 1000 / calls
        say(f"  tp.reduce of one f32 row of {row.shape[1]} on the one-rank NCCL group: {per_ms:.4f} ms a call (host "
            f"wall over {calls}); {2 * plain.config.decoder.block_count} a decode step: "
            f"{per_ms * 2 * plain.config.decoder.block_count:.3f} ms")
        for what in ("batch", "dp"):
            for i, (a, b) in enumerate(zip(want["batch"], got[what])):
                say(f"  {'transcribe_batch' if what == 'batch' else 'dp-split batch (dp=1)'} clip {i}: "
                    f"{len(b)} tokens, {_mesh_verdict(plain, meshed, clips[i], a, b, f'{what} {i}')}")

        # the sequence-parallel encoder at sp=1 on the 300 s clip's mel (512 chunks)
        sp_mesh = encoder_sp.make_sp_mesh(1, device_type="cuda")
        padded, n_audio, _ids, _len, mel_frames, num_chunks = plain._prepare(speechlike(300.0, seed=SEED + 90))
        mel, _clip_max = wmel.log_mel_with_max(torch.from_numpy(padded).cuda(), mel_frames)
        chunk = plain.config.audio.chunk_frames
        mel = torch.nn.functional.pad(mel, (0, 0, 0, num_chunks * chunk - mel.shape[0]))
        with torch.no_grad():
            one = encode_chunks(plain.config.audio, plain.encoder_params, mel, n_audio, num_chunks)
            sp = encoder_sp.encode_chunks_sp(plain.config.audio,
                                             encoder_sp.replicate_params(plain.encoder_params, sp_mesh),
                                             mel, n_audio, num_chunks, sp_mesh)
        err = float((sp[:n_audio].float() - one[:n_audio].float()).abs().max())
        say(f"  encode_chunks_sp sp=1, {num_chunks} chunks ({n_audio} valid tokens): max|d| {err:.3g} from "
            f"encode_chunks (tol 2e-2)")
        require(bool(torch.isfinite(sp).all()) and err <= 2e-2, f"encode_chunks_sp differs by {err}")
        if profile_dir:
            for model, tag in ((plain, "mesh-12s-unmeshed"), (meshed, "mesh-12s")):
                model.max_new_tokens = 32
                profile_run(torch, tag, f"12 s transcribe, {'dp1 x tp1 mesh' if model is meshed else 'no mesh'}, "
                            f"32 decode steps", lambda: model.transcribe(clip), profile_dir)
    del plain, meshed
    torch.cuda.empty_cache()
    say(f"phase mesh: ok (dp1 x tp1 on NCCL; decode {got['step_ms']:.3f} ms/step meshed vs "
        f"{want['step_ms']:.3f} unmeshed; {time.perf_counter() - t_phase:.1f} s)")


def profile_run(torch, tag: str, label: str, run, out_dir: str) -> None:
    """``run()`` once to warm, then once under torch.profiler: device time and
    launches by kernel (the table under ``out_dir``) and the device's busy
    share of the wall."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    os.makedirs(out_dir, exist_ok=True)
    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000
    events = prof.key_averages()
    kernels = [e for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1000
    n_kernels = sum(e.count for e in kernels)
    path = os.path.join(out_dir, f"profile_{tag}.txt")
    with open(path, "w") as f:
        f.write(f"{card_line()}\n{label}: wall {wall_ms:.3f} ms, device kernels {device_ms:.3f} ms in "
                f"{n_kernels} launches\n{events.table(sort_by='self_device_time_total', row_limit=30)}\n"
                f"by host time:\n{events.table(sort_by='self_cpu_time_total', row_limit=30)}\n")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        say(f"  profile {tag}: {e.key[:70]} {e.self_device_time_total / 1000:.3f} ms x{e.count}")
    busy = device_ms / wall_ms if wall_ms else float("nan")
    say(f"  profile {tag} ({label}): wall {wall_ms:.3f} ms, device kernels {device_ms:.3f} ms in "
        f"{n_kernels} launches, busy share {busy:.3f} -> {os.path.relpath(path, REPO)}")


def phase_profile(torch, model, out_dir: str, steps: int = 32):
    """torch.profiler over a 12 s transcribe (with and without
    ``LWT_FUSED_FFN``) and a B = 8 ``transcribe_batch`` of 3 s clips, each
    cut to ``steps`` decode steps (:func:`profile_run`)."""
    from light_whisper_tpu_torch.eval.speechlike import speechlike

    def fused_route():
        os.environ["LWT_FUSED_FFN"] = "1"
        try:
            return model.transcribe(speechlike(12.0, seed=SEED + 1))
        finally:
            os.environ.pop("LWT_FUSED_FFN", None)

    workloads = (("12s", "12 s transcribe", lambda: model.transcribe(speechlike(12.0, seed=SEED + 1))),
                 ("12s-fused", "12 s transcribe, LWT_FUSED_FFN=1", fused_route),
                 ("batch8", "B=8 transcribe_batch of 3 s clips",
                  lambda: model.transcribe_batch([speechlike(3.0, seed=SEED + 60 + i) for i in range(8)])))
    keep = model.max_new_tokens
    model.max_new_tokens = steps
    try:
        for tag, label, run in workloads:
            profile_run(torch, tag, f"{label}, {steps} decode steps", run, out_dir)
    finally:
        model.max_new_tokens = keep
    say("phase profile: ok")


def _serve_cli(model_path: str, root: str, label: str, requests: int) -> dict:
    """``engine_cli serve`` in a fresh process whose package is imported from
    ``root``: the wall from spawn to its ``init`` reply, then ``requests``
    2 s transcribes and ``exit``."""
    import tempfile

    from light_whisper_tpu_torch.eval.speechlike import speechlike

    env = _child_env(LIGHT_WHISPER_MODEL_PATH=model_path,
                     LIGHT_WHISPER_DATA_DIR=os.path.join(REPO, "build", "chip_smoke", "data"),
                     PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "light_whisper_tpu_torch.runtime.engine_cli", "serve", "--engine", "qwen3-asr-0.6b"]
    with tempfile.TemporaryFile("w+") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err, text=True, env=env,
                                cwd=root)
        killer = threading.Timer(600, proc.kill)  # a hung engine fails the phase, not the run
        killer.start()
        try:
            init = json.loads(proc.stdout.readline() or "{}")
            init_s = time.perf_counter() - t0
            replies = []
            for rid, seed in ((1, SEED), (2, SEED + 3))[:requests]:
                proc.stdin.write(json.dumps(_transcribe_cmd(rid, speechlike(2.0, seed=seed))) + "\n")
                proc.stdin.flush()
                replies.append(json.loads(proc.stdout.readline() or "{}"))
            proc.stdin.write(json.dumps({"action": "exit", "request_id": 3}) + "\n")
            proc.stdin.close()
            bye = json.loads(proc.stdout.readline() or "{}")
            proc.wait(timeout=120)
        finally:
            killer.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        stderr = err.read()
    require(proc.returncode == 0, f"{label} engine_cli exited {proc.returncode}: {stderr[-2000:]}")
    require(init.get("success") and init.get("backend") == "cuda", f"{label} engine_cli init {init} {stderr[-2000:]}")
    for tr in replies:
        require(tr.get("success") and tr.get("vad_segments", 0) >= 1, f"{label} engine_cli transcribe {tr}")
    require(bye.get("success"), f"{label} engine_cli exit {bye}")
    inference_ms = [tr["inference_ms"] for tr in replies]
    say(f"  {label}: spawn to init reply {init_s:.3f} s ({init.get('message')}); inference_ms {inference_ms}; "
        f"{time.perf_counter() - t0:.1f} s in all")
    return {"init_s": init_s, "inference_ms": inference_ms}


def _child_env(**extra) -> dict:
    """The environment of a child process: never ``LIGHT_WHISPER_FORCE_CPU``,
    which would move the port to the CPU without a word."""
    env = dict(os.environ, **extra)
    env.pop("LIGHT_WHISPER_FORCE_CPU", None)
    return env


def _dictate_cli(model_path: str, seconds: float = 4.0) -> dict:
    """``engine_cli dictate`` in a fresh process from the checkout, as the app
    would spawn it: no ``--device``, no ``--engine`` (the engine from
    ``LIGHT_WHISPER_ASR_ENGINE``), a speech-like WAV paced in real time."""
    import tempfile

    from light_whisper_tpu_torch.audio.pcm import encode_wav_mono_s16
    from light_whisper_tpu_torch.eval.speechlike import speechlike

    wav = os.path.join(REPO, "build", "chip_smoke", f"dictate-{seconds:g}s.wav")
    with open(wav, "wb") as f:
        f.write(encode_wav_mono_s16(speechlike(seconds, seed=SEED + 201), 16000))
    env = _child_env(LIGHT_WHISPER_MODEL_PATH=model_path, LIGHT_WHISPER_ASR_ENGINE="qwen3-asr-0.6b",
                     LIGHT_WHISPER_DATA_DIR=os.path.join(REPO, "build", "chip_smoke", "data"),
                     PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "light_whisper_tpu_torch.runtime.engine_cli", "dictate", "--wav", wav]
    with tempfile.TemporaryFile("w+") as err:
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=err, text=True, env=env, cwd=REPO,
                                  timeout=600)
        except subprocess.TimeoutExpired:
            raise PhaseError("engine_cli dictate did not finish in 600 s")
        wall = time.perf_counter() - t0
        err.seek(0)
        stderr = err.read()
    require(proc.returncode == 0, f"engine_cli dictate exited {proc.returncode}: {stderr[-2000:]}")
    events = [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]
    interims, final = check_dictation(events, seconds)
    require(sum(e["event"] == "final" for e in events) == 1, f"engine_cli dictate events {events}")
    device_lines = [line for line in stderr.splitlines() if "on device" in line]
    require(len(device_lines) == 1 and "on device cuda" in device_lines[0],
            f"engine_cli dictate's device log line: {device_lines}")
    say(f"  dictate ({seconds:g} s WAV, real time, fresh process): {wall:.3f} s from spawn to exit; "
        f"{device_lines[0].split(' - ')[-1]}")
    for event in events:
        say(f"    {json.dumps(event, ensure_ascii=False)[:300]}")
    return {"wall_s": wall, "ticks": len(interims), "asr_ms": final["asr_ms"]}


def phase_cli(model_path: str):
    """Warm start: a fresh ``engine_cli serve`` from a copy of the package
    whose kernel build directory is empty (``_build`` builds under the
    package's parent, so the copy builds its own: cold), then from the
    checkout, whose kernels this run built (warm)."""
    import shutil
    import tempfile

    with tempfile.TemporaryDirectory(prefix="lwt-cold-", dir=os.path.join(REPO, "build")) as root:
        shutil.copytree(os.path.join(REPO, "light_whisper_tpu_torch"), os.path.join(root, "light_whisper_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        require(not os.path.exists(os.path.join(root, "build")), "the cold copy has a build directory")
        cold = _serve_cli(model_path, root, "cold (empty kernel build)", requests=1)
        require(os.path.isdir(os.path.join(root, "build", "lwt_torch_kernels")), "the cold copy built no kernels")
    warm = _serve_cli(model_path, REPO, "warm (kernels built)", requests=2)
    dictated = _dictate_cli(model_path)
    say(f"phase cli: ok engine_cli serve init-to-ready cold {cold['init_s']:.3f} s, warm {warm['init_s']:.3f} s "
        f"(shell budget 120 s); inference_ms cold {cold['inference_ms']}, warm first/second {warm['inference_ms']}; "
        f"engine_cli dictate of 4 s {dictated['wall_s']:.3f} s ({dictated['ticks']} ticks, final asr_ms "
        f"{dictated['asr_ms']})")


# ---------------------------------------------------------------------------

# the main paths: through EngineServer, and engine_cli's dictation loop
WIRE_PATHS = ("slice", "batch", "longform", "single-pass", "fused-ffn", "interim", "dictate", "mesh")
KERNELS = (
    ("q8_matmul", "light_whisper_tpu_torch/csrc/q8_matmul.cu", "light_whisper_tpu/ops/q8_matmul.py:164",
     "logits T=1 152576x1024"),
    ("q8_matmul_stacked", "light_whisper_tpu_torch/csrc/q8_matmul.cu",
     "light_whisper_tpu/ops/q8_matmul.py:249", "qkv T=64 4096x1024"),
    ("q8_matmul_stacked_fused", "light_whisper_tpu_torch/csrc/q8_matmul.cu",
     "light_whisper_tpu/ops/q8_matmul.py:376", "qkv +norm T=1 4096x1024"),
    ("decode_attention", "light_whisper_tpu_torch/csrc/decode_attention.cu",
     "light_whisper_tpu/ops/decode_attention.py:100", "T=1 start=200 C=1024"),
    ("decode_attention_unstacked", "light_whisper_tpu_torch/csrc/decode_attention.cu",
     "light_whisper_tpu/ops/decode_attention.py:56", "T=64 start=0 C=1024"),
    ("decode_attention_batched", "light_whisper_tpu_torch/csrc/decode_attention.cu",
     "light_whisper_tpu/ops/decode_attention.py:215", "B=8 C=1024"),
    ("flash_prefill", "light_whisper_tpu_torch/csrc/flash_prefill.cu",
     "light_whisper_tpu/ops/flash_prefill.py:97", "T=3968 start=0 C=8192"),
    ("fused_ffn_step", "light_whisper_tpu_torch/csrc/fused_ffn.cu", "light_whisper_tpu/ops/fused_ffn.py:98",
     "T=1 D=1024"),
    # no wire path runs the four below, as in the reference: kernels phase only
    ("fused_gateup_silu", "light_whisper_tpu_torch/csrc/fused_ffn.cu", "light_whisper_tpu/ops/fused_ffn.py:210",
     "T=8 D=1024"),
    ("q8_probe", "light_whisper_tpu_torch/csrc/q8_probe.cu", "scripts/exp_q8_compute_bound.py:237",
     "load gateup T=8"),
    ("q8_matmul_perm", "light_whisper_tpu_torch/csrc/q8_probe.cu", "scripts/exp_q8_kperm_probe.py:146",
     "gateup T=8"),
    ("q8_matmul_stacked_perm", "light_whisper_tpu_torch/csrc/q8_probe.cu", "scripts/exp_q8_kperm_probe.py:175",
     "gateup T=8"),
)


def _no_reference_modules() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "light_whisper_tpu", "__graft_entry__", "helpers"))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="identify, build and check the kernels; skip the model phases")
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile a short 12 s transcribe (with and without LWT_FUSED_FFN, and with "
                             "and without a mesh), a B=8 batch and a 0.6B train step; tables under DIR")
    args = parser.parse_args(argv)

    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: torch is not importable: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if os.environ.get("LIGHT_WHISPER_FORCE_CPU"):
        print("chip_smoke: LIGHT_WHISPER_FORCE_CPU is set; it would move the port to the CPU", file=sys.stderr)
        return 2
    os.environ.pop("LIGHT_WHISPER_FORCE_CPU", None)  # an empty one too: no child inherits it
    if not os.path.isdir(os.path.join(REPO, "light_whisper_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (light_whisper_tpu_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False

    from light_whisper_tpu_torch.ops import decode_attention as da
    from light_whisper_tpu_torch.ops import flash_prefill as fp
    from light_whisper_tpu_torch.ops import fused_ffn as ffn
    from light_whisper_tpu_torch.ops import q8_matmul as q8
    from light_whisper_tpu_torch.scripts import exp_q8_compute_bound as cb
    from light_whisper_tpu_torch.scripts import exp_q8_kperm_probe as kp

    os.environ.pop("LWT_FUSED_FFN", None)  # the default route everywhere but the fused-ffn path
    os.environ.pop("LIGHT_WHISPER_DISABLE_SESSION_REUSE", None)  # set only around the stateless paths
    try:
        card = phase_identify(torch)
        phase_build()
        results = phase_kernels(torch)
        launches = Launches(torch, [q8.LAUNCHES, da.LAUNCHES, fp.LAUNCHES, ffn.LAUNCHES, cb.LAUNCHES, kp.LAUNCHES])
        if not args.kernels_only:
            phase_narrow(torch)
            engine, client, model_path, cfg = start_server()
            try:
                # the stateless paths, as the server served them before its sessions
                os.environ["LIGHT_WHISPER_DISABLE_SESSION_REUSE"] = "1"
                try:
                    reply_12s = phase_slice(torch, engine, client, cfg, launches)
                    phase_batch(torch, engine, client, launches)
                    phase_longform(torch, client, launches)
                    phase_single_pass(torch, engine, client, cfg, launches)
                    phase_fused_ffn(torch, engine, client, cfg, launches, reply_12s)
                finally:
                    os.environ.pop("LIGHT_WHISPER_DISABLE_SESSION_REUSE", None)
                phase_interim(torch, engine, client, launches)
                phase_dictate(torch, engine, launches)
                if args.profile:
                    phase_profile(torch, engine.model, args.profile)
                bye = client.call({"action": "exit", "request_id": 999})
                require(bye.get("success") is True, f"exit: {bye}")
            finally:
                client.close()
            del engine, client  # the client's server holds the engine's hooks
            torch.cuda.empty_cache()
            phase_precise(torch, model_path, launches)
            phase_train(torch, model_path, launches, profile_dir=args.profile)
            phase_mesh(torch, model_path, launches, profile_dir=args.profile)
            phase_cli(model_path)
        torch.cuda.synchronize()
        require(not _no_reference_modules(), f"imported: {_no_reference_modules()}")
    except PhaseError as exc:
        say(f"phase FAIL: {exc}")
        return 1

    kernels = []
    for name, source, replaces, case in KERNELS:
        row = next(r for r in results[name] if r["case"].startswith(case))
        # launches: summed over the wire paths, each counted from 0; the
        # kernel-vs-plain checks and the model-level checks are not counted
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": sum(launches.by_path.get(path, {}).get(name, 0) for path in WIRE_PATHS),
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    say(card)
    say(json.dumps({"kernels": kernels}))
    if args.kernels_only:
        say("kernels-only: the main path was not driven")
        return 0
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
