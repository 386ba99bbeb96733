"""Rollouts, approximation, Riccati DP and the CUDA kernel wrappers."""
from ratilqr_tpu_torch.ops.rollout import (integrate_cost, rollout_feedback,
                                           rollout_open_loop)
