"""Planar complex ops of the port and the fused path's kernel wrappers."""
