"""Port of the reference package's models/vad modules."""
