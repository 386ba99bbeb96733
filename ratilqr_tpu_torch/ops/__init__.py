"""Rollouts, approximation, Riccati DP and the CUDA kernel wrappers."""
from ratilqr_tpu_torch.ops.rollout import (integrate_cost, rollout_feedback,
                                           rollout_feedback_noisy,
                                           rollout_generative,
                                           rollout_open_loop,
                                           rollout_open_loop_noisy)
