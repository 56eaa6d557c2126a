"""Format-defined constant tables (numpy only)."""
