from ratilqr_tpu_torch.utils.numerics import isapprox, max_control_deviation
