"""Several trials of one configuration trained at once on one device."""
