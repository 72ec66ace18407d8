"""Frozen measuring pieces: problem generation, bounds, peaks, counts."""
