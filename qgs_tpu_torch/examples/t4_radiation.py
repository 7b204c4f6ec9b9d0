"""Full quartic T^4 longwave radiation scheme (implies dynamic 0-th order
temperatures): the quartic inner products are computed on the sorted-index
simplex and the tendency tensor is rank 5 (counterpart of
``examples/t4_radiation.py``)."""

import numpy as np

from qgs_tpu_torch.examples import F64, cli, pyplot, savefig
from qgs_tpu_torch.examples.dynamic_temperature import initial_state
from qgs_tpu_torch.integrators.rk import (integrate_runge_kutta,
                                          integrate_runge_kutta_df)
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.ops.twofloat import DfTendency
from qgs_tpu_torch.params.params import QgParams

# time units at dt 0.01: the first run, the plotted run, the twofloat one
TIMES = {False: dict(first=50., span=200., df=10.),
         True: dict(first=1., span=2., df=1.)}
# twofloat against float64 (PERF.md section 2: about 48 bits, 1e-14 after
# 10,000 steps)
TOLERANCES = {"y_first": F64, "traj": F64, "y64": F64, "ydf": F64}


def params(QgParams=QgParams):
    """``T4=True`` activates the full quartic Stefan-Boltzmann law without
    linearization (and so dynamic 0-th order temperatures)."""
    pars = QgParams({'rr': 287.e0, 'sb': 5.6e-8}, T4=True)
    pars.set_params({'kd': 0.04, 'kdp': 0.04, 'n': 1.5})
    pars.set_atmospheric_channel_fourier_modes(2, 2, mode='symbolic')
    pars.set_oceanic_basin_fourier_modes(2, 4, mode='symbolic')
    return pars


def main(device="cuda", short=False, plot=True, outdir="."):
    plt = pyplot() if plot else None
    times = TIMES[short]
    pars = params()

    # The quartic coefficient families are computed once on the
    # sorted-index simplex and scattered to every index permutation; on the
    # device the rank-5 tensor stays sparse.
    f, Df, tensor = create_tendencies(pars, return_qgtensor=True,
                                      device=device)
    print("T4 tensor rank:", tensor.tensor.rank, " nnz:", tensor.tensor.nnz)

    # The contraction runs on a two-level layout: each output row's
    # entries in chunks of C slots (pads add exactly zero), the chunk sums,
    # then each row's chunk sums, in a fixed order and a fixed number of
    # launches whatever the spread of the row counts.
    fb = f.batched
    n_chunks, C = fb.vals.shape
    n_rows, K = fb.chunks.shape
    slots = n_chunks * C + n_rows * K
    kept = int(np.count_nonzero(np.asarray(tensor.tensor.coords)[0]))
    print(f"rank-5 entries: {kept} outside the dummy row -> two-level "
          f"layout: {n_chunks} chunks of {C} slots + {n_rows} rows of {K} "
          f"chunk sums = {slots} slots ({slots / kept:.2f} an entry)")

    x0 = initial_state(pars)
    vr = pars.variables_range
    steps = int(round(times["first"] / 0.01))
    _, y = integrate_runge_kutta(fb, 0., times["first"], 0.01, x0,
                                 write_steps=0)
    y_first = y.cpu().numpy()
    print(f"state after {steps} steps finite:",
          bool(np.isfinite(y_first).all()))

    # The 0-th order temperatures relax toward radiative-convective
    # equilibrium while the flow variables stay chaotic.
    t, traj = integrate_runge_kutta(fb, 0., times["span"], 0.01, x0,
                                    write_steps=50)
    traj = traj.cpu().numpy()

    # Precision: the double-float tier runs the same rank-5 tendency on the
    # same layout, every product and sum an error-free transformation.
    _, y64 = integrate_runge_kutta(fb, 0., times["df"], 0.01, x0[None, :],
                                   write_steps=0)
    fdf = DfTendency(tensor.tensor.coords, tensor.tensor.data,
                     tensor.tensor.shape, device=device)
    _, ydf = integrate_runge_kutta_df(fdf, 0., times["df"], 0.01,
                                      x0[None, :], write_steps=0,
                                      squeeze=False)
    y64, ydf = y64.cpu().numpy(), ydf.cpu().numpy()
    err = float(np.abs(ydf - y64).max())
    steps_df = int(round(times["df"] / 0.01))
    print(f"twofloat vs f64 after {steps_df} quartic RK4 steps: {err:.2e}")

    if plot:
        fig, axs = plt.subplots(1, 2, figsize=(11, 3.5))
        axs[0].plot(t, traj[vr[0]], label="$T_{a,0}$")
        axs[0].plot(t, traj[vr[2]], label="$T_{o,0}$")
        axs[0].set_xlabel("time (nondim)")
        axs[0].set_title("0-th order temperatures")
        axs[0].legend()
        axs[1].plot(t, traj[0], label=r"$\psi_{a,1}$")
        axs[1].plot(t, traj[vr[0] + 1], label=r"$\theta_{a,1}$")
        axs[1].set_xlabel("time (nondim)")
        axs[1].set_title("flow variables")
        axs[1].legend()
        fig.tight_layout()
        savefig(plt, outdir, "t4_series.png")
        print("wrote t4_series.png")
    return dict(slots=slots, y_first=y_first, traj=traj, y64=y64, ydf=ydf,
                err=err)


if __name__ == "__main__":
    cli(main)
