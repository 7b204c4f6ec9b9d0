"""Contraction and kernel selection: what the port runs for each
``mode=`` name and each precision (counterpart of
``examples/kernel_selection.py``).

Every model reduces to ONE sparse tensor contraction a tendency
evaluation, ``dx_i/dt = sum_jk T[i,j,k] x_j x_k`` (rank 5 for the quartic
schemes).  The port evaluates it by one gather path: each output row's
entries padded to the longest row, gathered, multiplied and summed in a
fixed order (a pad has value 0 and gathers the constant 1, so it adds
exactly 0).  The JAX package's other ``mode=`` names (``bucketed``,
``rowsum``, ``coo``, ``dense``, ...) are accepted and run that path.  A
whole RK4 integration of a rank-3 tensor on the card is one launch of a
fused kernel: the RK4 kernel in float64 or float32, its double-float twin
for ``precision='twofloat'``.
"""

import numpy as np
import torch

from qgs_tpu_torch.examples import F32, F64, cli
from qgs_tpu_torch.examples.maooam_coupled import params
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.ops import fused_df_rk4, fused_rk4
from qgs_tpu_torch.ops.contraction import MODES, make_tendency_fns

B = 64
TIMES = {False: dict(span=100.), True: dict(span=10.)}
TOLERANCES = {"f_auto": F64, "y_float64": F64, "y_float32": F32,
              "y_twofloat": F64}


def main(device="cuda", short=False, plot=True, outdir="."):
    # nothing is drawn: plot and outdir are accepted for the common call
    times = TIMES[short]
    pars = params()
    f, Df, qgt = create_tendencies(pars, return_qgtensor=True, device=device)
    T, JT = qgt.tensor, qgt.jacobian_tensor
    print(f"ndim {pars.ndim}, tensor nnz {T.nnz}")

    # every mode name builds the same gather path: its deviation from
    # 'auto' is exactly zero
    modes = {mode: make_tendency_fns(T, JT, mode=mode, device=device)[0]
             for mode in ("auto", "bucketed", "rowsum", "coo", "dense")}
    x = torch.as_tensor(np.random.default_rng(0).random((4, pars.ndim))
                        * 0.05, device=device)
    ref = modes["auto"](0., x)
    deviations = {}
    for mode, fn in modes.items():
        deviations[mode] = float((fn(0., x) - ref).abs().max())
        print(f"  mode {mode:>9}: max deviation from auto "
              f"{deviations[mode]:.2e}")

    # Not carried from the JAX package: the structural key, the operand
    # pytree threaded through jit and the compiled-executable cache (a
    # module is built once from the host tensor; a new parameter value
    # builds a new module), and the dense matricized operand.
    print("kernel menu:", " | ".join(MODES), "(one gather path)")

    # Which kernel each precision launches: the integrator's float64 and
    # float32 routes (by the tendency's dtype) go to the fused RK4 kernel,
    # twofloat to the double-float one.  On the CPU the kernels' plain
    # versions run and nothing is launched.
    f32, _ = make_tendency_fns(T, JT, dtype=torch.float32, device=device)
    ic = np.random.default_rng(1).random((B, pars.ndim)) * 0.01
    finals, launches = {}, {}
    for name, fn, precision in (("float64", f, "float64"),
                                ("float32", f32, "float64"),
                                ("twofloat", f, "twofloat")):
        integ = RungeKuttaIntegrator(precision=precision)
        integ.set_func(fn)
        k1, k2 = fused_rk4.launches, fused_df_rk4.launches
        integ.integrate(0., times["span"], 0.1, ic=ic, write_steps=0)
        finals[name] = integ.get_trajectories()[1].double().cpu().numpy()
        launches[name] = {"rk4_fused": fused_rk4.launches - k1,
                          "rk4_df_fused": fused_df_rk4.launches - k2}
        print(f"  {name:<8} integrate on {device}: kernel launches "
              f"{launches[name]}")
    return dict(f_auto=ref.cpu().numpy(), deviations=deviations,
                y_float64=finals["float64"], y_float32=finals["float32"],
                y_twofloat=finals["twofloat"], launches=launches)


if __name__ == "__main__":
    cli(main)
