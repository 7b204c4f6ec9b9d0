"""Dynamic 0-th order temperature scheme: T_a0 and T_o0 become prognostic
variables and the tendency tensor becomes rank 5 (counterpart of
``examples/dynamic_temperature.py``)."""

import numpy as np

from qgs_tpu_torch.examples import F64, cli, pyplot, savefig
from qgs_tpu_torch.integrators.rk import integrate_runge_kutta
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.ops.contraction import make_direct_tangent
from qgs_tpu_torch.params.params import QgParams

# time units at dt 0.01: the printed series, and the plotted run
TIMES = {False: dict(series=100., span=500.),
         True: dict(series=5., span=10.)}
TOLERANCES = {"series": F64, "traj": F64, "direct": F64}


def params(QgParams=QgParams):
    """With ``dynamic_T=True`` the reference temperatures T_a0 / T_o0 stop
    being fixed parameters and become prognostic 0-th order variables; the
    radiation terms then mix up to four state variables and the tendency
    tensor becomes rank 5 (kept sparse).  Quartic inner products need the
    symbolic basis mode."""
    pars = QgParams({'rr': 287.e0, 'sb': 5.6e-8}, dynamic_T=True)
    pars.set_params({'kd': 0.04, 'kdp': 0.04, 'n': 1.5})
    pars.set_atmospheric_channel_fourier_modes(2, 2, mode='symbolic')
    pars.set_oceanic_basin_fourier_modes(2, 4, mode='symbolic')
    return pars


def initial_state(pars):
    """A small random state with the 0-th order temperatures near their
    expected nondimensional magnitudes (``variables_range`` gives each
    block's index span)."""
    x0 = np.random.default_rng(0).random(pars.ndim) * 0.01
    vr = pars.variables_range
    x0[vr[0]] = 0.1      # T_a0
    x0[vr[2]] = 0.12     # T_o0
    return x0


def main(device="cuda", short=False, plot=True, outdir="."):
    plt = pyplot() if plot else None
    times = TIMES[short]
    pars = params()
    print("variables:", pars.ndim, "->", pars.var_string[:3], "...",
          pars.var_string[-3:])

    # A tendency call of the rank-5 tensor runs plain torch ops over a
    # two-level layout (each row's entries in chunks, then the chunk sums);
    # on a CUDA card a classical RK4 integration of it is one launch of K5,
    # the fused rank-5 RK4 kernel.
    f, Df, tensor = create_tendencies(pars, return_qgtensor=True,
                                      device=device)
    print("tensor rank:", tensor.tensor.rank, " nnz:", tensor.tensor.nnz)
    x0 = initial_state(pars)
    vr = pars.variables_range

    _, y = integrate_runge_kutta(f.batched, 0., times["series"], 0.01, x0,
                                 write_steps=100)
    series = y[vr[0]].cpu().numpy()
    print("T_a0 series:", np.array2string(series[:8], precision=5))
    print("final state finite:", bool(np.isfinite(y.cpu().numpy()).all()))

    # The prognostic temperatures approach a radiative equilibrium set by
    # the insolation/emissivity balance while the flow equilibrates.
    t, traj = integrate_runge_kutta(f.batched, 0., times["span"], 0.01, x0,
                                    write_steps=100)
    traj = traj.cpu().numpy()

    # The tangent-linear system of the rank-5 model: the direct tangent
    # forms the (B, n, n) coefficient on the device and multiplies it by
    # the tangent block.  Given NumPy arrays it returns NumPy.
    hom = make_direct_tangent(tensor.jacobian_tensor, device=device)
    x_end = traj[:, -1]
    xx = np.concatenate([np.ones(1), x_end])[None, :]
    dm = np.eye(pars.ndim)[None, :, :4]              # four tangent directions
    J = Df.batched(0., x_end[None, :])[0]
    direct = hom(xx, dm)[0]
    err = float(np.abs(direct - J @ dm[0]).max())
    print("direct-tangent vs dense-Jacobian product:", err)

    if plot:
        fig, ax = plt.subplots(figsize=(7, 3.5))
        ax.plot(t, traj[vr[0]], label="$T_{a,0}$")
        ax.plot(t, traj[vr[2]], label="$T_{o,0}$")
        ax.set_xlabel("time (nondim)")
        ax.set_ylabel("nondim temperature")
        ax.set_title("prognostic 0-th order temperatures")
        ax.legend()
        fig.tight_layout()
        savefig(plt, outdir, "dynT_temperatures.png")
        print("wrote dynT_temperatures.png")
    return dict(series=series, traj=traj, direct=direct, err=err)


if __name__ == "__main__":
    cli(main)
