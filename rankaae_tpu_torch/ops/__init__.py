"""Losses, statistics and the Kendall rank-correlation kernels."""
