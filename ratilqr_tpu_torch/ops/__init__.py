"""Rollouts, approximation, Riccati DP and the CUDA kernel wrappers."""
from ratilqr_tpu_torch.ops.approx import Approximation, approximate_model
from ratilqr_tpu_torch.ops.riccati import (DPResult, decrease_mu_delta,
                                           dp_evaluate, dp_optimize,
                                           increase_mu_delta)
from ratilqr_tpu_torch.ops.rollout import (integrate_cost, rollout_feedback,
                                           rollout_feedback_noisy,
                                           rollout_feedback_with_jac,
                                           rollout_generative,
                                           rollout_open_loop,
                                           rollout_open_loop_noisy,
                                           rollout_open_loop_with_jac)
