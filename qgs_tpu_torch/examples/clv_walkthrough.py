"""Covariant Lyapunov vectors in depth on the RP atmosphere: spectrum,
local exponents, physical structure, near-tangencies and the covariance
property (counterpart of ``examples/clv_walkthrough.py``)."""

import numpy as np
import torch

from qgs_tpu_torch.diagnostics.util import create_grid_basis
from qgs_tpu_torch.examples import F64, FIELD, LYAP, cli, pyplot, savefig
from qgs_tpu_torch.examples.external_solvers import params
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.integrators.rk import make_tgls_step, rk4_tableau
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.toolbox.lyapunov import (CovariantLyapunovsEstimator,
                                            LyapunovsEstimator)

# time units: the spin-up; the Benettin run (tw, t); the Ginelli run (ta,
# tb, tc)
TIMES = {False: dict(transient=5000., tw=200., t=1200., ta=300., tb=400.,
                     tc=700.),
         True: dict(transient=100., tw=10., t=30., ta=5., tb=15., tc=25.)}
# angles between two CLVs, in degrees: arccos amplifies the vectors'
# rounding near 0
ANGLES = dict(rtol=1e-6, atol=1e-6)
TOLERANCES = {"ic": F64, "spectrum": LYAP, "clv_spectrum": LYAP,
              "angles": ANGLES, "align": F64, "psi_bg": FIELD, "psi_v1": FIELD}


def main(device="cuda", short=False, plot=True, outdir="."):
    plt = pyplot() if plot else None
    times = TIMES[short]
    # the RP atmosphere (20 variables): small enough that every Lyapunov
    # object is cheap to compute and to look at
    pars = params()
    f, Df = create_tendencies(pars, device=device)

    integrator = RungeKuttaIntegrator()
    integrator.set_func(f)
    rng = np.random.default_rng(3)
    integrator.integrate(0., times["transient"], 0.1,
                         ic=rng.random(pars.ndim) * 0.01, write_steps=0)
    _, ic = integrator.get_trajectories()
    ic = torch.atleast_2d(ic)

    # The asymptotic picture first: the backward Lyapunov spectrum by the
    # Benettin QR algorithm, a positive pair (chaos), a near-zero exponent
    # (the flow direction) and a dissipative tail.
    est = LyapunovsEstimator()
    est.set_func(f, Df)
    est.compute_lyapunovs(0., times["tw"], times["t"], 0.1, 0.1, ic,
                          write_steps=1)
    _, _, bexps, _ = est.get_lyapunovs()
    spectrum = np.sort(bexps.mean(axis=-1))[::-1]
    print("Backward Lyapunov spectrum:", np.array2string(spectrum,
                                                         precision=4))

    # CLVs by the Ginelli method: a forward Benettin pass stores (Q, R)
    # over [ta, tb], a backward triangular-solve pass from tc converges the
    # covariant coefficients.  CLVs are norm-1 but mutually oblique.
    cest = CovariantLyapunovsEstimator()
    cest.set_func(f, Df)
    cest.compute_clvs(0., times["ta"], times["tb"], times["tc"], 0.1, 0.1,
                      ic, write_steps=1)
    t, traj, cexps, clvs = cest.get_clvs()
    clv_spectrum = np.sort(cexps.mean(-1))[::-1]
    print("CLV mean exponents:   ",
          np.array2string(clv_spectrum[:6], precision=4), "(leading 6)")
    lead = int(np.argmax(cexps.mean(-1)))

    # A CLV is a perturbation pattern: its psi components are spectral
    # coefficients of a perturbation streamfunction, evaluated on the grid
    # next to the background flow at mid-window.
    nx, ny = 120, 60
    X, Y = np.meshgrid(np.linspace(0, 2 * np.pi / pars.scale_params.n, nx),
                       np.linspace(0, np.pi, ny))
    Fgrid = create_grid_basis(pars.atmospheric_basis, X, Y)
    natm = pars.nmod[0]
    k = clvs.shape[-1] // 2
    psi_bg = np.tensordot(traj[:natm, k], Fgrid, axes=(0, 0))
    psi_v1 = np.tensordot(clvs[:natm, lead, k], Fgrid, axes=(0, 0))

    # Near-tangencies (angles collapsing to zero) between the two leading
    # CLVs mark violations of hyperbolicity.
    ang = np.degrees(np.arccos(np.clip(np.abs(
        np.einsum('nt,nt->t', clvs[:, lead], clvs[:, lead + 1])), 0, 1)))
    print(f"min CLV1-CLV2 angle along the window: {ang.min():.2f} deg "
          f"(near-tangency events below ~10 deg: {(ang < 10).sum()})")

    # The covariance property: one step of the tangent flow takes CLV_j(t)
    # onto span(CLV_j(t + dt)).  The step runs on the model's device.
    a, b, c = rk4_tableau()
    step = make_tgls_step(f.batched, Df.batched, a, b, c)
    y = torch.as_tensor(traj[:, k][None], device=device)
    V = torch.as_tensor(clvs[:, :, k][None], device=device)
    _, V2 = step((y, V), 0.0, 0.1)
    V2 = V2[0].cpu().numpy()
    V2 /= np.linalg.norm(V2, axis=0)
    align = np.array([abs(np.dot(V2[:, j], clvs[:, j, k + 1]))
                      for j in range(4)])
    print("covariance check |<M CLV_j(t), CLV_j(t+dt)>| (leading 4):",
          np.array2string(align, precision=6))

    if plot:
        n = np.arange(1, pars.ndim + 1)
        fig, ax = plt.subplots(figsize=(7, 3.5))
        ax.bar(n - 0.2, spectrum, 0.4, label="BLV (Benettin)")
        ax.bar(n + 0.2, clv_spectrum, 0.4,
               label="CLV (Ginelli, time-mean local)")
        ax.axhline(0, color='k', lw=0.5)
        ax.set_xlabel("index")
        ax.set_ylabel("Lyapunov exponent (1/timeunit)")
        ax.legend()
        fig.tight_layout()
        savefig(plt, outdir, "clv_spectrum.png", dpi=90)

        fig, ax = plt.subplots(figsize=(8, 3))
        ax.plot(t, cexps[lead], lw=0.7)
        ax.axhline(cexps[lead].mean(), color='r', ls='--',
                   label=f"mean = {cexps[lead].mean():.3f}")
        ax.set_xlabel("time")
        ax.set_ylabel(r"local $\lambda_1(t)$")
        ax.legend()
        fig.tight_layout()
        savefig(plt, outdir, "clv_local_exponent.png", dpi=90)

        fig, axs = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
        cs = axs[0].contourf(X, Y, psi_bg, 15, cmap="RdBu_r")
        fig.colorbar(cs, ax=axs[0], label=r"$\psi_a$ (background)")
        cs = axs[1].contourf(X, Y, psi_v1, 15, cmap="PuOr")
        axs[1].contour(X, Y, psi_bg, 8, colors='k', linewidths=0.4)
        fig.colorbar(cs, ax=axs[1], label=r"CLV$_1$ $\psi$-pattern")
        axs[1].set_xlabel("x")
        for ax in axs:
            ax.set_ylabel("y")
        fig.tight_layout()
        savefig(plt, outdir, "clv_pattern.png", dpi=90)

        fig, ax = plt.subplots(figsize=(6, 3))
        ax.hist(ang, bins=40, color="#46658c")
        ax.set_xlabel(r"angle between CLV$_1$ and CLV$_2$ (deg)")
        ax.set_ylabel("count")
        fig.tight_layout()
        savefig(plt, outdir, "clv_angles.png", dpi=90)
        print("wrote clv_spectrum.png, clv_local_exponent.png, "
              "clv_pattern.png, clv_angles.png")
    return dict(ic=ic.cpu().numpy(), spectrum=spectrum,
                clv_spectrum=clv_spectrum, angles=ang, align=align,
                psi_bg=psi_bg, psi_v1=psi_v1)


if __name__ == "__main__":
    cli(main)
