from ratilqr_tpu_torch.models.examples import (double_integrator, lqr_problem,
                                               nonlinear_toy, unicycle)
