"""Image <-> block-tensor layout."""
