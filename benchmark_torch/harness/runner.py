"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the plain reference, and the result line.

    python3 benchmark_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up is everything from process start to the window's first request:
imports, the artifact (written on a checkout's first run only), the engine's
own ``init`` (load, upload, VAD, the server's warm-up, the kernel build on a
first run) and the mix's ``warm_up_rounds`` requests from each client, which
take every shape the window sends (every clip of a mix has one length). The window then runs the mix's closed loop for ``--seconds``;
requests sent before its close are waited for. ``--trace 1`` profiles a
bounded slice at the window's start (clients held at its end until nothing
is in flight) and reports the per-layer metrics; ``--trace 0`` the
end-to-end ones.

``--rehearse`` runs the same path on the CPU with the kernels' plain
versions and prints counts and checks only, no device metric.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from harness import artifact, measures, spec, traffic as traffic_mod
from harness.client import ClosedLoop, PipeClient, Request

FORBIDDEN = ("jax", "jaxlib", "flax", "light_whisper_tpu")
SLICE_SECONDS = 1.0  # profiled at the window's start; every request sent in it is answered in it
STREAM_PREFIX = "user-"
WARM_PREFIX = "warm-"
NO_GAPS = 1e30  # what each gap number reads where no token was compared


class RunError(RuntimeError):
    pass


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def require_clean_imports() -> None:
    bad = forbidden_modules()
    if bad:
        raise RunError(f"the benchmark must not import {bad[:5]}")


def card(torch) -> Dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            info["power_limit"] = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return info


def set_cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    build = os.path.join(root, "build")
    for var, sub in (("CUDA_CACHE_PATH", "cuda_cache"), ("TRITON_CACHE_DIR", "triton_cache"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(build, sub)


def start_engine(cell: spec.Cell, path: str, device: str):
    from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel
    from light_whisper_tpu_torch.runtime.qwen3_server import Qwen3EngineServer

    budget = int(cell.config["max_new_tokens"])
    engine = Qwen3EngineServer(engine=cell.config["engine"], device=device, model_path=path,
                               model_factory=lambda p: Qwen3ASRModel(p, device=device, max_new_tokens=budget))
    wire = PipeClient(engine.hooks())
    init = wire.read()
    if init.get("success") is not True:
        raise RunError(f"engine init failed: {init}")
    wire.start_reader()
    return engine, wire


def step_list(engine, stream: str) -> Optional[list]:
    """The decode steps' host walls of the stream's last request, where the
    program keeps them: its session's transcriber, or the model on the
    stateless path."""
    pool = getattr(engine, "_session_pool", None)
    if pool:
        bridge = pool._bridges.get(stream)
        return bridge._inc.last_decode_step_s if bridge is not None else None
    model = engine.model
    return getattr(model, "last_decode_step_s", None)


def on_reply(engine):
    def record(req: Request) -> None:
        if req.reply and req.reply.get("success"):
            req.tokens = artifact.parse_tokens(req.reply.get("text", ""))
            req.steps = step_list(engine, f"{STREAM_PREFIX}{req.client}")
    return record


def launch_counters() -> Dict[str, int]:
    from light_whisper_tpu_torch.ops import decode_attention, flash_prefill, fused_ffn, q8_matmul

    out: Dict[str, int] = {}
    for module in (q8_matmul, decode_attention, flash_prefill, fused_ffn):
        out.update(module.LAUNCHES)
    return out


def reference_sample(requests: List[Request], traffic, count: int, seed: int) -> List[Request]:
    """Every finished request that served its clip something not yet compared
    (a clip served again with the same tokens reads the same), or ``count``
    of them drawn from the seed, the longest among them, where there are more."""
    seen, done = set(), []
    for r in sorted((r for r in requests if measures.ok(r) and r.tokens is not None), key=lambda r: r.rid):
        key = (r.utterance, tuple(r.tokens))
        if key not in seen:
            seen.add(key)
            done.append(r)
    if len(done) <= count:
        return done
    longest = max(done, key=lambda r: (len(traffic.utterances[r.utterance]), -r.rid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, 0xC0DE]))
    picks = rng.choice(len(rest), size=count - 1, replace=False)
    return [longest] + [rest[int(i)] for i in sorted(picks)]


def gap_numbers(gaps: List[float]) -> Dict[str, float]:
    """What the served tokens' logit gaps say: their mean, the mean of their
    squares, how many are not the reference's first choice, the widest."""
    g = np.asarray(gaps, np.float64)
    if not g.size:
        return dict.fromkeys(("mean_logit_gap", "mean_square_logit_gap", "tokens_not_first", "widest_logit_gap"),
                             NO_GAPS)
    return {"mean_logit_gap": float(g.mean()), "mean_square_logit_gap": float((g * g).mean()),
            "tokens_not_first": int((g > 0).sum()), "widest_logit_gap": float(g.max())}


def gap_checks(limits: Dict, numbers: Dict[str, float], compared: int, expected: int) -> Dict[str, Dict]:
    """The gap numbers that ``limits`` holds a limit for, and the count of
    tokens that were due a comparison and had none."""
    checks = {"tokens_not_compared": {"value": expected - compared, "limit": 0}}
    for name, value in numbers.items():
        if name in limits:
            checks[name] = {"value": value, "limit": float(limits[name])}
    return checks


@dataclasses.dataclass
class Comparison:
    checks: Dict[str, Dict]  # the program's numbers, each with its limit
    numbers: Dict[str, Dict[str, float]]  # every gap number, of the program and of the control
    compared: int  # requests compared
    control: Optional[Dict[str, Dict]] = None  # the control's numbers in the program's place


def compare(cell: spec.Cell, traffic, requests: List[Request], seed: int, device: str,
            control: bool = False) -> Comparison:
    """Every number compared, each with its limit (``correct`` is all within),
    and with ``control`` the same numbers of the control's picks in the
    program's place (which must come out not correct)."""
    from harness.reference import Reference

    budget = int(cell.config["max_new_tokens"])
    failed = sum(1 for r in requests if not (r.reply and r.reply.get("success")))
    unreadable = sum(1 for r in requests if r.reply and r.reply.get("success") and r.reply.get("vad_segments", 0)
                     and (r.tokens is None or len(r.tokens) != budget))
    silent = sum(1 for r in requests if r.reply and r.reply.get("success") and not r.reply.get("vad_segments", 0))
    sample = reference_sample(requests, traffic, int(cell.limits["reference_requests"]), seed)
    t = time.perf_counter()
    ref = Reference(cell.config, cell.arch, device, control=control)
    results = ref.run([{"pcm": traffic.utterances[r.utterance], "tokens": r.tokens} for r in sample])
    trim_mismatch = sum(1 for r, res in zip(sample, results)
                        if res["samples"] != measures.speech_samples(r) or res["segments"] != r.reply["vad_segments"])
    expected = budget * max(1, len(sample))
    measures.note(f"the reference{' and the control' if control else ''} took {time.perf_counter() - t:.1f} s")
    out = Comparison(checks={}, numbers={}, compared=len(sample))
    for side, key in (("program", "gaps"), ("control", "control_gaps"))[: 2 if control else 1]:
        gaps = [g for res in results for g in res.get(key, [])]
        out.numbers[side] = gap_numbers(gaps)
        measures.note(f"{side}: logit gaps over {len(gaps)} served tokens of {len(sample)} requests (of "
                      f"{len(requests)} sent): " + ", ".join(f"{k} {v}" for k, v in out.numbers[side].items()))
        checks = gap_checks(cell.limits, out.numbers[side], len(gaps), expected)
        if side == "program":
            out.checks = {
                "failed_requests": {"value": failed, "limit": 0},
                "speechless_replies": {"value": silent, "limit": 0},
                "unreadable_replies": {"value": unreadable, "limit": 0},
                "trim_mismatches": {"value": trim_mismatch, "limit": 0},
                **checks,
            }
        else:
            out.control = checks
    return out


def all_within(checks: Dict[str, Dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def run_window(engine, wire, traffic, seconds: float, trace: bool, torch, first_rid: int):
    from harness import trace as trace_mod

    record_slice = {}
    loop = ClosedLoop(wire, traffic, STREAM_PREFIX, first_rid, on_reply(engine))

    def during(lp: ClosedLoop, start: float) -> None:
        if not trace:
            return
        time.sleep(max(0.0, start + SLICE_SECONDS - time.perf_counter()))
        lp.pause()
        device_ev, host_ev = prof.stop()
        after = launch_counters()
        t_end = time.perf_counter()
        requests = list(lp.requests)
        record_slice["span"] = (start - 1e-9, t_end)
        record_slice["slice"] = trace_mod.reduce(device_ev, host_ev, prof.t1 - prof.t0,
                                                 {k: after[k] - before[k] for k in after}, requests)
        lp.resume()

    if trace:
        prof = trace_mod.Profiler(torch)
        before = launch_counters()
        prof.start()
    start = loop.run(seconds=seconds, during=during)
    return loop.requests, start, record_slice


def warm_up(wire, traffic, rounds: int, first_rid: int) -> int:
    """``rounds`` requests of each client, as the window sends them, on
    streams of their own (a window's first request must not find its own
    audio parked in a session). Every clip of a mix has one length, so this
    takes every shape the window sends."""
    loop = ClosedLoop(wire, traffic, WARM_PREFIX, first_rid, lambda req: None)
    loop.run(sends=rounds)
    bad = [r.reply for r in loop.requests if not (r.reply and r.reply.get("success"))]
    if bad:
        raise RunError(f"warm-up request failed: {bad[0]}")
    return first_rid + len(loop.requests) + 1


def run(args, t_process: float) -> int:
    root = os.path.abspath(args.root)
    cell = spec.find_cell(root, args.workload)
    import torch

    if args.rehearse:
        device = "cpu"
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"benchmark: the cell needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()}", file=sys.stderr)
            return 2
        device = "cuda"
    set_cache_dirs(root)
    if root not in sys.path:
        sys.path.insert(0, root)
    for key, value in cell.config.get("env", {}).items():
        os.environ[key] = str(value)
    require_clean_imports()

    phases = {"imports": time.perf_counter() - t_process}
    t = time.perf_counter()
    path = artifact.ensure(root, cell, device)
    phases["artifact"] = time.perf_counter() - t
    t = time.perf_counter()
    traffic = traffic_mod.generate(cell.traffic, args.seed)
    phases["traffic"] = time.perf_counter() - t
    t = time.perf_counter()
    engine, wire = start_engine(cell, path, device)
    phases["engine_init"] = time.perf_counter() - t
    t = time.perf_counter()
    rid = warm_up(wire, traffic, int(cell.traffic["warm_up_rounds"]), 1000)
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
    phases["warm_up"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_process
    measures.note(f"set-up {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
                  + f"; engine init phases {engine._init_timings}")

    stats_before = wire.call({"action": "stats"}, rid)["stats"]
    trace = bool(args.trace) and device == "cuda"
    requests, start, traced = run_window(engine, wire, traffic, args.seconds, trace, torch, rid + 1)
    stats_after = wire.call({"action": "stats"}, rid + len(requests) + 10)["stats"]
    peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
    wire.close()
    del engine, wire
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    require_clean_imports()

    record = measures.Record(cell=cell.name, shapes=cell.arch.shapes(cell.config), arch=cell.arch,
                             budget=int(cell.config["max_new_tokens"]), seconds=args.seconds, setup_s=setup_s,
                             requests=requests, t_open=start, stats_before=stats_before, stats_after=stats_after,
                             slice=traced.get("slice"), slice_span=traced.get("span", (0.0, 0.0)))
    checks = compare(cell, traffic, requests, args.seed, device).checks
    correct = all_within(checks)
    attempted = len(requests)
    failed = sum(1 for r in requests if not (r.reply and r.reply.get("success")))
    metrics = {}
    wanted = [] if args.rehearse else cell.per_layer if args.trace else cell.end_to_end
    for m in wanted:
        value = record.setup_s if m.name == "setup_s" else spec.reader(m.name, root)(record)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    for r in requests:
        reply = r.reply or {}
        measures.note(f"request {r.rid} client {r.client} utterance {r.utterance} sent +{r.t_sent - start:.3f} s "
                      f"latency {measures.latency_ms(r):.1f} ms inference {reply.get('inference_ms')} vad "
                      f"{reply.get('vad_ms')} audio {reply.get('duration')} s steps {len(r.steps or [])}")
    measures.note(f"{len(record.in_window())} of {attempted} requests answered in the {args.seconds} s window; "
                  f"{len(record.served())} outside the traced slice")
    for name, c in checks.items():  # the numbers compared, each beside its limit, last on standard error
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    if args.rehearse:
        print(json.dumps({"rehearsal": True, "correct": correct, "attempted": attempted, "failed": failed,
                          "answered_in_window": len(record.in_window()), "checks": checks}))
        return 0
    device_info = {**card(torch), "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": device_info}
    if record.slice is not None:
        out["device"]["busy_s"] = record.slice.busy_s
        out["device"]["window_s"] = record.slice.window_s
        out["breakdown"] = record.slice.breakdown()
    out["checks"] = checks
    print(json.dumps(out))
    return 0


def parse(argv=None):
    p = argparse.ArgumentParser(description="benchmark of the PyTorch/CUDA port, one cell a run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--root", default=".", help="the checkout holding BENCHMARK.json (default: here)")
    p.add_argument("--rehearse", action="store_true", help="run on the CPU with the plain kernels; no device metric")
    return p.parse_args(argv)


def main(argv=None, t_process: Optional[float] = None) -> int:
    t_process = time.perf_counter() if t_process is None else t_process
    args = parse(argv)
    try:
        return run(args, t_process)
    except (RunError, KeyError, FileNotFoundError, ImportError) as exc:
        print(f"benchmark: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 2
