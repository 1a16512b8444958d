"""Port of the reference package's serving modules."""
