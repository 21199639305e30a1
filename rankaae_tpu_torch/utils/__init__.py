"""Host utilities: config, weight bridge, logging, device selection."""
