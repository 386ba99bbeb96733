from ratilqr_tpu_torch.models.examples import (cartpole, double_integrator,
                                               gmm_integrator, lqr_problem,
                                               nonlinear_toy, quadrotor,
                                               unicycle)
