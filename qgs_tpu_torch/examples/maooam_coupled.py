"""Coupled ocean-atmosphere (MAOOAM): a short run and a dashboard of
atmospheric and oceanic streamfunctions and temperatures (counterpart of
``examples/maooam_coupled.py``)."""

import numpy as np

from qgs_tpu_torch.diagnostics.multi import MultiDiagnostic
from qgs_tpu_torch.diagnostics.streamfunctions import (
    MiddleAtmosphericStreamfunctionDiagnostic,
    OceanicLayerStreamfunctionDiagnostic)
from qgs_tpu_torch.diagnostics.temperatures import (
    MiddleAtmosphericTemperatureAnomalyDiagnostic,
    OceanicLayerTemperatureAnomalyDiagnostic)
from qgs_tpu_torch.examples import F64, FIELD, cli, pyplot, savefig
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.params.params import QgParams

TIMES = {False: dict(transient=2.e4, span=2000.),
         True: dict(transient=100., span=100.)}
TOLERANCES = {"time": F64, "traj": F64, "fields_last": FIELD}


def params(QgParams=QgParams):
    """MAOOAM of De Cruz, Demaeyer & Vannitsem (GMD 2016): a 2x2-block
    channel atmosphere over a 2x4-block closed ocean basin, coupled
    mechanically (wind stress d, friction kd) and thermally (heat exchange
    and linearized radiation); 36 variables."""
    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_oceanic_basin_fourier_modes(2, 4)
    pars.set_params({'kd': 0.0290, 'kdp': 0.0290, 'n': 1.5, 'r': 1.e-7,
                     'h': 136.5, 'd': 1.1e-7})
    pars.atemperature_params.set_params({'eps': 0.7, 'T0': 289.3,
                                         'hlambda': 15.06})
    pars.gotemperature_params.set_params({'gamma': 5.6e8, 'T0': 301.46})
    pars.atemperature_params.set_insolation(103.3333, 0)
    pars.gotemperature_params.set_insolation(310., 0)
    return pars


def main(device="cuda", short=False, plot=True, outdir="."):
    plt = pyplot() if plot else None
    times = TIMES[short]
    pars = params()

    # The ocean's slow heat reservoir makes true equilibration take about
    # 1e6 time units; 2e4 is enough for a qualitative dashboard.  Each
    # integrate call is one launch of the fused RK4 kernel on the card.
    f, Df = create_tendencies(pars, device=device)
    integrator = RungeKuttaIntegrator()
    integrator.set_func(f)
    rng = np.random.default_rng(0)
    integrator.integrate(0., times["transient"], 0.1,
                         ic=rng.random(pars.ndim) * 0.01, write_steps=0)
    _, y0 = integrator.get_trajectories()
    integrator.integrate(0., times["span"], 0.1, ic=y0, write_steps=20)
    t, traj = integrator.get_trajectories()

    # A 2x2 dashboard of gridded fields sharing one trajectory: each field
    # is computed on the device whether or not a frame is drawn.
    m = MultiDiagnostic(2, 2)
    for cls in (MiddleAtmosphericStreamfunctionDiagnostic,
                MiddleAtmosphericTemperatureAnomalyDiagnostic,
                OceanicLayerStreamfunctionDiagnostic,
                OceanicLayerTemperatureAnomalyDiagnostic):
        m.add_diagnostic(cls(pars, device=device))
    fields = m(t, traj)
    last = np.stack([fd[-1].cpu().numpy() for fd in fields])
    for d, fl in zip(m.diagnostics_list, last):
        print(f"{type(d).__name__}: last record in [{fl.min():.4g}, "
              f"{fl.max():.4g}]")
    if plot:
        m.plot(time_index=-1)
        savefig(plt, outdir, "maooam_dashboard.png")
        print("wrote maooam_dashboard.png")
    return dict(time=np.asarray(t), traj=traj.cpu().numpy(), fields_last=last)


if __name__ == "__main__":
    cli(main)
