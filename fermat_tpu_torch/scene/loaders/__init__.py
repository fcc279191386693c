"""Scene file loaders (numpy on the host)."""
