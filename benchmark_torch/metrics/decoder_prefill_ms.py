"""Mean host wall of the prompt embeds, decoder prefill and first logits' dispatch, ending without a sync (the model.prefill span)."""

from harness.spans import mean_ms


def read(record):
    return mean_ms(record, "model.prefill")
