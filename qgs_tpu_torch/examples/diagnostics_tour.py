"""Tour of the diagnostics catalog on an RP-atmosphere trajectory
(counterpart of ``examples/diagnostics_tour.py``)."""

import numpy as np

from qgs_tpu_torch.diagnostics.eddy import (
    MiddleAtmosphericEddyHeatFluxDiagnostic,
    MiddleAtmosphericEddyHeatFluxProfileDiagnostic)
from qgs_tpu_torch.diagnostics.multi import MultiDiagnostic
from qgs_tpu_torch.diagnostics.streamfunctions import (
    LowerLayerAtmosphericStreamfunctionDiagnostic,
    MiddleAtmosphericStreamfunctionDiagnostic,
    UpperLayerAtmosphericStreamfunctionDiagnostic)
from qgs_tpu_torch.diagnostics.temperatures import (
    AtmosphericTemperatureMeridionalGradientDiagnostic,
    MiddleAtmosphericTemperatureAnomalyDiagnostic)
from qgs_tpu_torch.diagnostics.vorticity import (
    MiddleAtmosphericVorticityDiagnostic,
    UpperLayerAtmosphericPotentialVorticityDiagnostic)
from qgs_tpu_torch.diagnostics.wind import (
    MiddleAtmosphericUWindDiagnostic, MiddleAtmosphericVWindDiagnostic,
    MiddleAtmosphericWindIntensityDiagnostic, MiddleLayerVerticalVelocity)
from qgs_tpu_torch.examples import F64, FIELD, cli, pyplot, savefig
from qgs_tpu_torch.examples.rp_atmosphere import params
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.models.tendencies import create_tendencies

TIMES = {False: dict(transient=2.e4, span=500.),
         True: dict(transient=100., span=20.)}
TOLERANCES = {"traj": F64, "fields_last": FIELD, "profile_last": FIELD}

# Twelve field diagnostics.  Each reconstructs its field on a lat-lon grid
# as one matrix product of the spectral coefficients with the gridded
# basis; MiddleLayerVerticalVelocity solves the omega equation from the
# difference between the full and the thermodynamic-only tendencies.
CATALOG = (
    LowerLayerAtmosphericStreamfunctionDiagnostic,
    UpperLayerAtmosphericStreamfunctionDiagnostic,
    MiddleAtmosphericStreamfunctionDiagnostic,
    MiddleAtmosphericTemperatureAnomalyDiagnostic,
    AtmosphericTemperatureMeridionalGradientDiagnostic,
    MiddleAtmosphericUWindDiagnostic,
    MiddleAtmosphericVWindDiagnostic,
    MiddleAtmosphericWindIntensityDiagnostic,
    MiddleLayerVerticalVelocity,
    MiddleAtmosphericVorticityDiagnostic,
    UpperLayerAtmosphericPotentialVorticityDiagnostic,
    MiddleAtmosphericEddyHeatFluxDiagnostic,
)


def main(device="cuda", short=False, plot=True, outdir="."):
    plt = pyplot() if plot else None
    times = TIMES[short]
    pars = params()
    f, Df = create_tendencies(pars, device=device)
    integrator = RungeKuttaIntegrator()
    integrator.set_func(f)
    rng = np.random.default_rng(0)
    integrator.integrate(0., times["transient"], 0.1,
                         ic=rng.random(pars.ndim) * 0.1, write_steps=0)
    _, y0 = integrator.get_trajectories()
    integrator.integrate(0., times["span"], 0.1, ic=y0, write_steps=10)
    t, traj = integrator.get_trajectories()

    # the twelve fields in one dashboard, all computed on the device
    m = MultiDiagnostic(4, 3)
    for cls in CATALOG:
        m.add_diagnostic(cls(pars, device=device))
    fields = m(t, traj)
    last = [fd[-1].cpu().numpy() for fd in fields]
    for cls, fl in zip(CATALOG, last):
        print(f"{cls.__name__:<52} last record in [{np.nanmin(fl):.4g}, "
              f"{np.nanmax(fl):.4g}]")

    # A profile diagnostic reduces a field to a meridional profile: here
    # the zonally averaged eddy heat flux v'T'.
    prof = MiddleAtmosphericEddyHeatFluxProfileDiagnostic(pars, device=device)
    profile = prof(t, traj)
    print("eddy heat flux profile, last record: "
          f"[{float(profile[-1].min()):.4g}, {float(profile[-1].max()):.4g}]")
    if plot:
        m.plot(time_index=-1, figsize=(22, 18))
        savefig(plt, outdir, "diagnostics_tour.png", dpi=80)
        prof.plot(time_index=-1)
        savefig(plt, outdir, "eddy_profile.png")
        print("wrote diagnostics_tour.png, eddy_profile.png")
    return dict(traj=traj.cpu().numpy(), fields_last=np.stack(last),
                profile_last=profile[-1].cpu().numpy())


if __name__ == "__main__":
    cli(main)
