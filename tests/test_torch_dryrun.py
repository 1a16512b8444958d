"""The port's multi-device dry run on four CPU ranks over gloo
(``python -m light_whisper_tpu_torch.parallel.dryrun --devices 4 --device
cpu``): every leg of the reference's ``__graft_entry__.dryrun_multichip``
passes and prints its line, in the reference's order and words."""

from light_whisper_tpu_torch.parallel import dryrun

LEGS = (
    "dryrun_multichip OK: mesh=dp2xtp2 loss=",
    "dryrun_multichip decode OK: tp2-sharded greedy decode matches single-device (16 tokens)",
    "dryrun_multichip pipeline OK: pp2 staged forward matches single-device; train-step loss=",
    "dryrun_multichip serving OK: tp2-sharded incremental tick (KV rollback + tail prefill + draft verify) "
    "matches single-device (6 tokens)",
    "dryrun_multichip serving OK: tp2-sharded Q8 incremental tick compiled and executed (6 tokens",
    "dryrun_multichip serving OK: dp4-sharded multi-stream batched decode matches single-device (4 streams)",
)


def test_dryrun_multichip_passes_every_leg_on_four_cpu_ranks(capsys):
    dryrun.dryrun_multichip(4, device="cpu", timeout_s=180)
    lines = capsys.readouterr().out.splitlines()
    print("\n".join(lines))
    assert len(lines) == len(LEGS)
    for line, start in zip(lines, LEGS):
        assert line.startswith(start), (line, start)
