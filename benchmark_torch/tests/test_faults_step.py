"""``correct`` comes out false when the B=1 decode of the dictation cell
leaves its cache as it found it. That decode steps with the batched forward
on a 1-stream view of the session's cache (``decoder.decode_step``), so the
fault is planted there: after each 1-stream step the device and the host
positions are put back."""

import json

from harness import runner


def test_a_b1_step_that_leaves_its_cache_unchanged_is_not_correct(workspace, monkeypatch, capsys):
    from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec

    seen = []
    forward = dec.forward_decode_batch

    def frozen(cfg, params, x, cache, *args, **kwargs):
        pos, host = cache.pos.clone(), list(cache.pos_host)
        out = forward(cfg, params, x, cache, *args, **kwargs)
        if x.shape[0] == 1:
            seen.append(1)
            cache.pos.copy_(pos)
            cache.pos_host = host
        return out

    monkeypatch.setattr(dec, "forward_decode_batch", frozen)
    rc = runner.main(["--workload", "tiny.dictation", "--seed", "5", "--seconds", "3", "--root", str(workspace),
                      "--rehearse"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert seen  # the fault sat on the path the cell times
    assert rc == 0 and result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
