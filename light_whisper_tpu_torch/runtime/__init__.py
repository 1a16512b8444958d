"""Port of the reference package's runtime modules."""
