"""Reference-import-path shim: the reference exposes the functional
integrators as ``qgs.integrators.integrate``; in the port they live in
:mod:`qgs_tpu_torch.integrators.rk`.  Re-exported here so that reference
code ports with only the package rename."""

from qgs_tpu_torch.integrators.rk import (             # noqa: F401
    integrate_runge_kutta, integrate_runge_kutta_tgls,
    integrate_runge_kutta_df, rk4_tableau, rk2_tableau, time_grid,
)
