"""Optimizers with runtime learning rates and ReduceLROnPlateau as state."""
