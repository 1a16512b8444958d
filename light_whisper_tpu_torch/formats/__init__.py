"""Port of the reference package's formats modules."""
