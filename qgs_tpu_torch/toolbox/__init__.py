"""Analysis toolbox of the port: the Lyapunov vectors and exponents
(:mod:`qgs_tpu_torch.toolbox.lyapunov`)."""
