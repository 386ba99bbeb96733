"""Rollouts, approximation, Riccati DP and the CUDA kernel wrappers."""
