#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py                  # every phase (one card)
    python3 chip_smoke.py --kernels-only   # identify, build, kernel-vs-plain checks

Phases, one line each (``phase <name>: ok|FAIL ...``):

1. identify the card (``nvidia-smi`` name and power limit, torch and CUDA versions);
2. build the kernels of ``light_whisper_tpu_torch/csrc`` with ``nvcc``;
3. each kernel against its plain PyTorch version on the card, at Qwen3-ASR
   0.6B shapes, with the tolerance stated on each line (integer-valued cases
   bitwise) and kernel / plain times from CUDA events;
4. a narrow model (head dim 128, two query heads per KV head) transcribed on
   the card and on the CPU (plain versions): logits and greedy tokens compared;
5. the slice: a 0.6B-width Q8_0 GGUF with random weights from a seed, served
   by the port's engine server through the wire loop on in-memory pipes
   (init, a 2 s and a 12 s speech-like request, silence, stats, exit), with
   the kernels' launch counts taken over those requests;
6. ``engine_cli serve`` in a subprocess: init, one transcribe, exit.

Then the ``nvidia-smi`` line, a JSON line with one entry per kernel and, as
the last line, ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero without that line. No JAX is imported: the port reuses only the
JAX-free modules of ``light_whisper_tpu`` (GGUF, config, tokenizer, wire
server, VAD segmenter, speech-like test audio).
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 5
CARD_TIMEOUT_S = 60


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
        if "registers" in line or "spill" in line or "smem" in line:
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


def phase_kernels(torch):
    from light_whisper_tpu_torch.ops import decode_attention as da
    from light_whisper_tpu_torch.ops import q8_matmul as q8

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

    def record(form, case, err, tol, ms, plain_ms, bitwise=False, ulp_case=False):
        ok = err == 0 if bitwise else err <= tol
        tol_txt = "bitwise" if bitwise else f"tol={tol:.3g}"
        if ulp_case:
            ok, tol_txt = True, f"<= 1 bf16 ulp of max(|acc|,|out|) (+1e-3 max|acc| with norm) elementwise (worst {tol:.2f} ulp)"
        say(f"  {form} {case}: max|d|={err:.3g} {tol_txt} kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
            f"{'ok' if ok else 'FAIL'}")
        require(ok, f"{form} {case}: max|d| {err} over {tol_txt}")
        results.setdefault(form, []).append(
            {"case": case, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})

    def check(form, case, kernel_fn, plain_fn, calls, tol_rel=1e-4, tol_abs=None, ulp_of=None):
        got = kernel_fn(0)
        want = plain_fn(0)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err = float(diff.max())
        if ulp_of is not None:
            # bf16(res + bf16(acc)): f32 sums taken in another order may round
            # bf16(acc) one ulp apart, i.e. one bf16 ulp of max(|acc|, |out|)
            # (plus tol_rel of max|acc| when the norm prologue's scale, summed in
            # another order, may move a normalised input by one bf16 ulp)
            acc = ulp_of(0)
            ulp = _bf16_ulp(torch, torch.maximum(want.abs(), acc.abs()))
            slack = tol_rel * max(1.0, float(acc.abs().max()))
            bad = diff > ulp * 1.0001 + slack
            require(not bool(bad.any()),
                    f"{form} {case}: {int(bad.sum())} elements over 1 bf16 ulp + {slack:.3g} (max|d| {err:.3g})")
            tol = float((diff / ulp).max())  # reported in ulps
        elif tol_abs is not None:
            tol = tol_abs
        else:
            tol = tol_rel * max(1.0, float(want.abs().max()))
        record(form, case, err, tol, _time_ms(torch, kernel_fn, calls), _time_ms(torch, plain_fn, calls),
               ulp_case=ulp_of is not None)

    # -- 2D: logits head at decode, encoder fc2 / conv_out at 12 s ----------
    for case, T, N, K in (("logits T=1 152576x1024", 1, 152576, 1024),
                          ("enc.fc2 T=156 896x3584", 156, 896, 3584),
                          ("enc.conv_out T=156 896x7680", 156, 896, 7680)):
        qw, sw = weights(1, N, K)
        x = randn(T, K).to(torch.bfloat16)
        check("q8_matmul", case, lambda i: q8.q8_matmul(x, qw[0], sw[0]),
              lambda i: q8.q8_matmul_plain(x, qw[0], sw[0]), calls=8)

    # -- stacked: decoder projections at prefill (28 layers, cycled) --------
    L = 28
    proj = {"qkv": (4096, 1024), "o": (1024, 2048), "gateup": (6144, 1024), "down": (1024, 3072)}
    stacks = {name: weights(L, N, K) for name, (N, K) in proj.items()}
    for T in (64, 192):
        for name, (N, K) in proj.items():
            qw, sw = stacks[name]
            x = randn(T, K).to(torch.bfloat16)
            check("q8_matmul_stacked", f"{name} T={T} {N}x{K}",
                  lambda i: q8.q8_matmul_stacked(x, qw, sw, i % L),
                  lambda i: q8.q8_matmul_plain(x, qw[i % L], sw[i % L]), calls=L)

    # -- stacked-fused at decode (T=1) ---------------------------------------
    eps = 1e-6
    for case, name, with_norm, with_res in (("qkv +norm", "qkv", True, False),
                                            ("o +residual", "o", False, True),
                                            ("down +norm +residual", "down", True, True)):
        N, K = proj[name]
        qw, sw = stacks[name]
        x = randn(1, K).to(torch.bfloat16)
        norm_w = (1.0 + randn(K, scale=0.1)) if with_norm else None
        res = randn(1, N).to(torch.bfloat16) if with_res else None
        check("q8_matmul_stacked_fused", f"{case} T=1 {N}x{K}",
              lambda i: q8.q8_matmul_stacked_fused(x, qw, sw, i % L, norm_w=norm_w, eps=eps, residual=res),
              lambda i: q8.q8_matmul_fused_plain(x, qw[i % L], sw[i % L], norm_w, eps, res),
              calls=L, tol_rel=1e-3 if with_norm else 0.0,
              ulp_of=(lambda i: q8.q8_matmul_fused_plain(x, qw[i % L], sw[i % L], norm_w, eps, None))
              if with_res else None)

    # -- integer-valued cases: bitwise -------------------------------------------
    def int_case(T, N, K):
        qi = torch.randint(-127, 128, (2, N, K), generator=gen, device=dev, dtype=torch.int8)
        si = torch.full((2, N, K // 32), 0.5, device=dev, dtype=torch.bfloat16)
        xi = torch.randint(-4, 4, (T, K), generator=gen, device=dev).to(torch.bfloat16)
        return qi, si, xi

    qi, si, xi = int_case(1, 1024, 1024)
    got = q8.q8_matmul(xi, qi[1], si[1])
    want = q8.q8_matmul_plain(xi, qi[1], si[1])
    record("q8_matmul", "integer T=1", float((got - want).abs().max()), 0.0, 0.0, 0.0, bitwise=True)
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

    # -- decode attention: 0.6B heads, cache C=1024 ---------------------------
    Hq, Hkv, hd, C = 16, 8, 128, 1024
    kc = randn(L, Hkv, C, hd).to(torch.bfloat16)
    vc = randn(L, Hkv, C, hd).to(torch.bfloat16)
    for T, starts in ((1, (0, 200, 1023)), (64, (0, 150, 960))):
        for start in starts:
            qx = randn(T, Hq, hd, scale=3.0)
            check("decode_attention", f"T={T} start={start} C={C}",
                  lambda i: da.decode_attention(qx, kc, vc, start, i % L),
                  lambda i: da.decode_attention_plain(qx, kc, vc, start, i % L),
                  calls=L, tol_abs=5e-3)  # bf16 rounding of p
    n_cases = sum(len(v) for v in results.values())
    say(f"phase kernels: ok {n_cases} cases")
    return results


# ---------------------------------------------------------------------------
# phase 4: narrow model on the card vs the CPU


def _write_model(path: str, cfg, seed: int, template: str) -> None:
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from helpers.tiny_model import tiny_tensors

    from light_whisper_tpu.models.qwen3_asr.export import write_model

    tokens, types = _vocab(cfg)
    meta = {
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.token_type": types,
        "tokenizer.ggml.merges": [],
        "tokenizer.chat_template": template,
    }
    tmp = path + ".tmp"
    write_model(tmp, cfg, tiny_tensors(cfg, seed=seed), meta, quantize=True)
    os.replace(tmp, path)


def _vocab(cfg):
    """Byte tokens, filler pieces, and the specials at the config's ids."""
    from light_whisper_tpu.models.qwen3_asr.tokenizer import byte_to_unicode

    b2u = byte_to_unicode()
    n = cfg.decoder.vocab_size
    tokens = [b2u[b] for b in range(256)] + [f"tok{i}" for i in range(256, n)]
    types = [1] * n
    for tid, text in ((cfg.pad_token_id, "<|endoftext|>"), (cfg.bos_token_id, "<|im_start|>"),
                      (cfg.eos_token_id, "<|im_end|>"), (cfg.audio_token_id, "<|audio_pad|>")):
        tokens[tid] = text
        types[tid] = 3
    return tokens, types


TEMPLATE = "<|im_start|>user\n{audio}<|im_end|>\n<|im_start|>assistant\n"


def phase_narrow(torch):
    from light_whisper_tpu.eval.speechlike import speechlike
    from light_whisper_tpu.models.qwen3_asr.config import AudioEncoderConfig, DecoderConfig, Qwen3ASRConfig
    from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel

    vocab = 1024
    cfg = Qwen3ASRConfig(
        audio=AudioEncoderConfig(num_mel_bins=128, d_model=128, block_count=2, head_count=2,
                                 feed_forward_length=256, downsample_hidden_size=32, output_dim=256,
                                 max_source_positions=200),
        decoder=DecoderConfig(vocab_size=vocab, embedding_length=256, block_count=3,
                              feed_forward_length=512, head_count=4, head_count_kv=2, key_length=128,
                              context_length=4096),
        audio_token_id=vocab - 4, bos_token_id=vocab - 3, eos_token_id=vocab - 2, pad_token_id=vocab - 1,
    )
    path = os.path.join(REPO, "build", "chip_smoke", f"narrow-seed{SEED}.gguf")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if not os.path.isfile(path):
        _write_model(path, cfg, SEED, TEMPLATE)
    audio = speechlike(2.0, seed=SEED)
    steps = 12
    gpu = Qwen3ASRModel(path, device="cuda", max_new_tokens=steps)
    cpu = Qwen3ASRModel(path, device="cpu", max_new_tokens=steps)
    ref_tokens = cpu.transcribe(audio).tokens
    ref_logits = cpu.teacher_forced_logits(audio, ref_tokens)
    got_logits = gpu.teacher_forced_logits(audio, ref_tokens)
    worst = 0.0
    flips = []
    for step, (r, g) in enumerate(zip(ref_logits, got_logits)):
        require(bool(torch.isfinite(g).all()), f"non-finite logits at step {step}")
        r, g = r[: cfg.decoder.vocab_size], g[: cfg.decoder.vocab_size]
        worst = max(worst, float((r - g).abs().max()) / max(1.0, float(r.abs().max())))
        if int(torch.argmax(r)) != int(torch.argmax(g)):
            top2 = torch.topk(r, 2).values
            flips.append((step, float(top2[0] - top2[1])))
    say(f"  narrow: greedy tokens {ref_tokens}; max|dlogit|/max|logit| = {worst:.3g}; argmax flips {flips}")
    require(worst <= 2e-2, f"narrow logits differ by {worst:.3g} (tol 2e-2 of max|logit|)")
    # a flip is a tie only inside the top-2 band of the exactness doctrine
    require(all(gap <= 1e-2 for _step, gap in flips), f"argmax flips outside the tie band: {flips}")
    got_tokens = gpu.transcribe(audio).tokens
    require(got_tokens == ref_tokens or bool(flips), f"card greedy {got_tokens} != CPU {ref_tokens}")
    say("phase narrow: ok (card vs CPU plain versions, d_model 256, hd 128, G 2)")


# ---------------------------------------------------------------------------
# phase 5: the slice through the wire loop


def _pcm_b64(audio) -> str:
    import numpy as np

    pcm = np.clip(np.round(np.asarray(audio) * 32767.0), -32768, 32767).astype("<i2")
    return base64.b64encode(pcm.tobytes()).decode()


class PipeClient:
    """The wire loop of ``engine_cli serve`` on a thread, over in-memory pipes."""

    def __init__(self, hooks):
        from light_whisper_tpu.runtime.server import EngineServer

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

    def call(self, command: dict) -> dict:
        self._to_server.write(json.dumps(command) + "\n")
        self._to_server.flush()
        return self.read()

    def close(self):
        self._to_server.close()
        self.thread.join(timeout=120)
        require(not self.thread.is_alive(), "engine server thread did not stop")
        self._from_server.close()


def _flagship_path():
    import __graft_entry__ as graft

    cfg = graft._flagship_config("0.6b")
    path = os.path.join(REPO, "build", "chip_smoke", f"qwen3-asr-0.6b-seed{SEED}.gguf")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if not os.path.isfile(path):
        t0 = time.perf_counter()
        _write_model(path, cfg, SEED, TEMPLATE)
        say(f"  built {os.path.relpath(path, REPO)} ({os.path.getsize(path) / 2**20:.0f} MiB) "
            f"in {time.perf_counter() - t0:.1f} s")
    return path, cfg


def phase_slice(torch, counters):
    import numpy as np

    from light_whisper_tpu.eval.speechlike import speechlike
    from light_whisper_tpu_torch.runtime.qwen3_server import Qwen3EngineServer

    os.environ["LIGHT_WHISPER_DISABLE_SESSION_REUSE"] = "1"
    path, cfg = _flagship_path()
    engine = Qwen3EngineServer(engine="qwen3-asr-0.6b", device="cuda", model_path=path)
    client = PipeClient(engine.hooks())
    try:
        init = client.read()
        require(init.get("success") is True, f"init failed: {init}")
        require(init.get("backend") == "cuda", f"init backend {init.get('backend')!r}")
        say(f"  init: {init.get('message')} phases={engine._init_timings}")

        for reset in counters:
            for key in reset:
                reset[key] = 0
        requests = (("speech 2 s", speechlike(2.0, seed=SEED), True),
                    ("speech 12 s", speechlike(12.0, seed=SEED + 1), True),
                    ("silence 3 s", np.zeros(3 * 16000, np.float32), False))
        step_ms = None
        for rid, (name, audio, speech) in enumerate(requests, start=1):
            reply = client.call({"action": "transcribe", "request_id": rid,
                                 "audio_base64": _pcm_b64(audio), "audio_format": "pcm_s16le",
                                 "sample_rate": 16000})
            require(reply.get("success") is True, f"{name}: {reply}")
            require(reply.get("backend") == "cuda", f"{name}: backend {reply.get('backend')!r}")
            if speech:
                require(reply.get("vad_segments", 0) >= 1, f"{name}: no VAD segment: {reply}")
                steps = engine.model.last_decode_step_s
                med = sorted(steps)[len(steps) // 2] * 1000 if steps else float("nan")
                if name == "speech 12 s":
                    step_ms = med
                say(f"  {name}: inference_ms={reply['inference_ms']} vad_ms={reply['vad_ms']} "
                    f"decode_steps={len(steps)} median_step_ms={med:.3f} text_chars={len(reply['text'])}")
            else:
                require(reply.get("vad_segments") == 0, f"{name}: expected no VAD segment: {reply}")
                say(f"  {name}: vad_segments=0 vad_ms={reply['vad_ms']}")
        torch.cuda.synchronize()
        launches = {k: v for c in counters for k, v in c.items()}
        stats = client.call({"action": "stats", "request_id": 9})
        require(stats.get("success") is True, f"stats: {stats}")
        bye = client.call({"action": "exit", "request_id": 10})
        require(bye.get("success") is True, f"exit: {bye}")
    finally:
        client.close()
    say(f"  launches during the requests: {launches}")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the main path")

    # the served model's prefill logits are finite and of the padded vocab width
    logits = engine.model.teacher_forced_logits(speechlike(2.0, seed=SEED), [1, 2])
    require(all(bool(torch.isfinite(l).all()) for l in logits), "non-finite flagship logits")
    require(logits[0].shape[-1] == 152_576, f"logits width {logits[0].shape[-1]}")
    say(f"phase slice: ok (0.6B width, {cfg.decoder.block_count} decoder layers, "
        f"{cfg.audio.block_count} encoder layers, decode {step_ms:.3f} ms/step median on 12 s)")
    return launches, path, engine.model


def phase_profile(torch, model, out_dir: str, steps: int = 32):
    """torch.profiler over one 12 s transcribe cut to ``steps`` decode steps:
    device time by kernel, and the device's busy share of the wall."""
    from light_whisper_tpu.eval.speechlike import speechlike

    audio = speechlike(12.0, seed=SEED + 1)
    keep = model.max_new_tokens
    model.max_new_tokens = steps
    try:
        model.transcribe(audio)  # warm
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            model.transcribe(audio)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1000
    finally:
        model.max_new_tokens = keep
    events = prof.key_averages()
    kernels = [e for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1000
    table = events.table(sort_by="self_device_time_total", row_limit=30)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "profile_12s.txt")
    with open(path, "w") as f:
        f.write(f"{card_line()}\n12 s transcribe, {steps} decode steps: wall {wall_ms:.3f} ms, "
                f"device kernels {device_ms:.3f} ms\n{table}\n")
    busy = device_ms / wall_ms if wall_ms else float("nan")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        say(f"  profile: {e.key[:70]} {e.self_device_time_total / 1000:.3f} ms x{e.count}")
    say(f"phase profile: ok wall {wall_ms:.3f} ms, device kernels {device_ms:.3f} ms, busy share {busy:.3f} "
        f"-> {os.path.relpath(path, REPO)}")


def phase_cli(model_path: str):
    from light_whisper_tpu.eval.speechlike import speechlike

    env = dict(os.environ, LIGHT_WHISPER_MODEL_PATH=model_path,
               LIGHT_WHISPER_DISABLE_SESSION_REUSE="1",
               LIGHT_WHISPER_DATA_DIR=os.path.join(REPO, "build", "chip_smoke", "data"),
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "light_whisper_tpu_torch.runtime.engine_cli", "serve",
           "--engine", "qwen3-asr-0.6b"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=REPO)
    try:
        lines = [json.dumps({"action": "transcribe", "request_id": 1,
                             "audio_base64": _pcm_b64(speechlike(2.0, seed=SEED)),
                             "audio_format": "pcm_s16le", "sample_rate": 16000}),
                 json.dumps({"action": "exit", "request_id": 2})]
        out, err = proc.communicate("\n".join(lines) + "\n", timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    replies = [json.loads(l) for l in out.splitlines() if l.strip()]
    require(proc.returncode == 0, f"engine_cli exited {proc.returncode}: {err[-2000:]}")
    require(len(replies) == 3, f"engine_cli replies {replies} stderr {err[-2000:]}")
    init, tr, bye = replies
    require(init.get("success") and init.get("backend") == "cuda", f"engine_cli init {init}")
    require(tr.get("success") and tr.get("vad_segments", 0) >= 1, f"engine_cli transcribe {tr}")
    require(bye.get("success"), f"engine_cli exit {bye}")
    say(f"phase cli: ok engine_cli serve: init + transcribe (inference_ms={tr['inference_ms']}) + exit "
        f"in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------

KERNELS = (
    ("q8_matmul", "light_whisper_tpu_torch/csrc/q8_matmul.cu", "light_whisper_tpu/ops/q8_matmul.py:164",
     "logits T=1 152576x1024"),
    ("q8_matmul_stacked", "light_whisper_tpu_torch/csrc/q8_matmul.cu",
     "light_whisper_tpu/ops/q8_matmul.py:249", "qkv T=64 4096x1024"),
    ("q8_matmul_stacked_fused", "light_whisper_tpu_torch/csrc/q8_matmul.cu",
     "light_whisper_tpu/ops/q8_matmul.py:376", "qkv +norm T=1 4096x1024"),
    ("decode_attention", "light_whisper_tpu_torch/csrc/decode_attention.cu",
     "light_whisper_tpu/ops/decode_attention.py:100", "T=1 start=200 C=1024"),
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="identify, build and check the kernels; skip the model phases")
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile a short 12 s transcribe and write the table under DIR")
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
    if not os.path.isdir(os.path.join(REPO, "light_whisper_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (light_whisper_tpu_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False

    from light_whisper_tpu_torch.ops import decode_attention as da
    from light_whisper_tpu_torch.ops import q8_matmul as q8

    try:
        card = phase_identify(torch)
        phase_build()
        results = phase_kernels(torch)
        launches = {}
        if not args.kernels_only:
            phase_narrow(torch)
            launches, model_path, model = phase_slice(torch, [q8.LAUNCHES, da.LAUNCHES])
            if args.profile:
                phase_profile(torch, model, args.profile)
            del model
            phase_cli(model_path)
        torch.cuda.synchronize()
        require("jax" not in sys.modules, "jax was imported")
    except PhaseError as exc:
        say(f"phase FAIL: {exc}")
        return 1

    kernels = []
    for name, source, replaces, case in KERNELS:
        row = next(r for r in results[name] if r["case"].startswith(case))
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches.get(name, 0), "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"]})
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
