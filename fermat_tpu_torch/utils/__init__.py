"""Host utilities: image I/O."""
