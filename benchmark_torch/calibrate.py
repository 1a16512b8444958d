#!/usr/bin/env python3
"""Readings that the comparison's limits are set from: the program's logit
gaps and the control's, on many seeds, in one process.

    python3 benchmark_torch/calibrate.py --workload qwen3-asr-0.6b.dictation --seeds 1,2,3 --seconds 51

One engine serves every seed: each seed's traffic runs a window of
``--seconds`` as a benchmark run does, then the plain reference compares the
requests a run compares, and the control (the reference with the activation
operands of its linear layers in float8, ``harness/reference.py``) reads the
same prompts and tokens and is judged by the same checks in the program's
place. One JSON line a seed on standard output, and under ``--out`` if given:
every gap number of both, and whether each came out correct. Not run by the
benchmark's own runs.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness import runner, spec, traffic as traffic_mod  # noqa: E402
from harness.client import ClosedLoop  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--root", default=".")
    p.add_argument("--out", help="append the JSON lines to this file too")
    p.add_argument("--rehearse", action="store_true", help="on the CPU (tiny configurations)")
    args = p.parse_args(argv)
    import torch

    root = os.path.abspath(args.root)
    cell = spec.find_cell(root, args.workload)
    device = "cpu" if args.rehearse else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    runner.set_cache_dirs(root)
    sys.path.insert(0, root)
    seeds = [int(s) for s in args.seeds.split(",")]
    path = runner.artifact.ensure(root, cell, device)
    engine, wire = runner.start_engine(cell, path, device)
    rid = runner.warm_up(wire, traffic_mod.generate(cell.traffic, seeds[0]), int(cell.traffic["warm_up_rounds"]),
                         1000)
    for seed in seeds:
        traffic = traffic_mod.generate(cell.traffic, seed)
        loop = ClosedLoop(wire, traffic, runner.STREAM_PREFIX, rid, runner.on_reply(engine))
        loop.run(seconds=args.seconds)
        rid += len(loop.requests) + 10
        c = runner.compare(cell, traffic, loop.requests, seed, device, control=True)
        outputs = len({tuple(r.tokens) for r in loop.requests if r.tokens is not None})
        line = {"workload": cell.name, "seed": seed, "requests": len(loop.requests), "compared": c.compared,
                "distinct_outputs": outputs,
                "program_correct": runner.all_within(c.checks), "control_correct": runner.all_within(c.control),
                "program": c.numbers["program"], "control": c.numbers["control"],
                "checks": {k: v["value"] for k, v in c.checks.items()},
                "control_checks": {k: v["value"] for k, v in c.control.items()}}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    wire.close()
    runner.require_clean_imports()
    return 0


if __name__ == "__main__":
    sys.exit(main())
