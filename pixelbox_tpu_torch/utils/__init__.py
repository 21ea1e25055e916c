"""Host utilities: locks, timing, device selection."""
