"""Port of the reference package's download modules."""
