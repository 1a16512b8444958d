"""Port of the reference package's text modules."""
