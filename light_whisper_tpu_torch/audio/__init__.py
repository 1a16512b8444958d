"""Port of the reference package's audio modules."""
