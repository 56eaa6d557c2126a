"""Container IO (DDS)."""
