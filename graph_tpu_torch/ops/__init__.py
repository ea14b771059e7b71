"""Torch operations the algorithm paths outside the EdgeEngine share."""
