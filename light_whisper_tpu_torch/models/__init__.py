"""Port of the reference package's models modules."""
