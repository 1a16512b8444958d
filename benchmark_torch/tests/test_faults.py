"""``correct`` comes out false for a program broken under the timed path, on
the B=1 decode of the dictation cells and on the batched fresh tick of the
streams cells, and the control (float8 activation operands), judged by the
same checks in the program's place, comes out not correct where the program
passes."""

import json

import pytest

from harness import runner


def other_filler(token: int) -> int:
    return 256 + (token - 255) % 252


def break_b1(monkeypatch, fault, seen):
    from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec

    if fault == "token_altered":
        greedy = dec.decode_greedy

        def altered(*args, **kwargs):
            out = greedy(*args, **kwargs)
            seen.append(1)
            if len(out) > 2:
                out[2] = other_filler(out[2])
            return out

        monkeypatch.setattr(dec, "decode_greedy", altered)
    else:  # the B=1 decode steps the batched forward on a 1-stream view of the session's cache
        forward = dec.forward_decode_batch

        def frozen(cfg, params, x, cache, *args, **kwargs):
            pos, host = cache.pos.clone(), list(cache.pos_host)
            out = forward(cfg, params, x, cache, *args, **kwargs)
            if x.shape[0] == 1:  # a decode step leaves its cache as it found it
                seen.append(1)
                cache.pos.copy_(pos)
                cache.pos_host = host
            return out

        monkeypatch.setattr(dec, "forward_decode_batch", frozen)


def break_batched(monkeypatch, fault, seen):
    """Faults of the batched fresh tick; ``seen`` gets each batch's size."""
    from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec
    from light_whisper_tpu_torch.serving import incremental_batch as ib

    if fault == "slot_token_altered":
        greedy = ib._decode_greedy_batch

        def altered(cfg, params, first, caches, *args, **kwargs):
            out = greedy(cfg, params, first, caches, *args, **kwargs)
            seen.append(out.shape[0])
            out[-1, 2] = other_filler(int(out[-1, 2]))  # one slot's token, where it is produced
            return out

        monkeypatch.setattr(ib, "_decode_greedy_batch", altered)
        return
    forward = dec.forward_decode_batch

    def broken(cfg, params, x, cache, *args, **kwargs):
        seen.append(x.shape[0])
        pos, host = cache.pos.clone(), list(cache.pos_host)
        out = forward(cfg, params, x, cache, *args, **kwargs)
        if fault == "batch_state_unchanged":  # the step leaves every slot's cache position as it found it
            cache.pos, cache.pos_host = pos, host
        elif x.shape[0] > 1:  # half the batch left out: its rows are never computed
            out[(x.shape[0] + 1) // 2:] = 0
        return out

    monkeypatch.setattr(dec, "forward_decode_batch", broken)


CASES = [("dictation", "token_altered", break_b1), ("dictation", "state_unchanged", break_b1),
         ("streams8", "slot_token_altered", break_batched), ("streams8", "batch_state_unchanged", break_batched),
         ("streams8", "batch_half_dropped", break_batched)]


@pytest.mark.parametrize("traffic,fault,plant", CASES, ids=[f"{t}-{f}" for t, f, _ in CASES])
def test_a_broken_program_is_not_correct(workspace, monkeypatch, capsys, traffic, fault, plant):
    seen = []
    plant(monkeypatch, fault, seen)
    rc = runner.main(["--workload", f"tiny.{traffic}", "--seed", "5", "--seconds", "3", "--root", str(workspace),
                      "--rehearse"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert seen and (traffic == "dictation" or max(seen) > 1), seen  # the fault sat on the path the cell times
    assert rc == 0 and result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_the_control_fails_where_the_program_passes(workspace, capsys):
    import calibrate

    assert calibrate.main(["--workload", "tiny.dictation", "--seeds", "31,32,33", "--seconds", "3", "--root",
                           str(workspace), "--rehearse"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 3
    assert all(x["program_correct"] and not x["control_correct"] for x in lines), lines
