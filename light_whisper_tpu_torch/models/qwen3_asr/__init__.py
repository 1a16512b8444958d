"""Port of the reference package's models/qwen3_asr modules."""
