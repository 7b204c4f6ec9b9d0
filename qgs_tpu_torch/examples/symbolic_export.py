"""Symbolic export: the model's right-hand side as code with a free
continuation parameter (here the bottom friction k_d), including an
AUTO-07p setup (counterpart of ``examples/symbolic_export.py``).  SymPy on
the host: nothing runs on the device."""

import os

import numpy as np

from qgs_tpu_torch.examples import cli
from qgs_tpu_torch.functions.symbolic_tendencies import (
    create_symbolic_tendencies, equation_as_function)
from qgs_tpu_torch.params.params import QgParams

TOLERANCES = {}          # host only: no device changes a number


def params(QgParams=QgParams):
    """The RP atmosphere on the symbolic path: inner products kept as
    SymPy expressions, so that parameters can stay symbolic in the final
    tendencies."""
    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
    pars.set_atmospheric_channel_fourier_modes(2, 2, mode='symbolic')
    pars.ground_params.set_orography(0.2, 1)
    pars.atemperature_params.set_thetas(0.2, 0)
    return pars


def write(outdir, name, text):
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, name), "w") as fh:
        fh.write(text)


def main(device="cuda", short=False, plot=True, outdir="."):
    # host only: device, short and plot are the common call's arguments
    pars = params()
    # the continuation parameter: every other parameter is substituted by
    # its value, k_d stays a free symbol in the generated code
    kd = pars.atmospheric_params.kd

    # One symbolic build of the equations, emitted in three languages.
    python_code, eq = create_symbolic_tendencies(
        pars, continuation_variables=[kd], language='python',
        return_symbolic_eqs=True)
    print("--- python RHS (first lines) ---")
    print("\n".join(python_code.split("\n")[:8]))
    fortran_code = equation_as_function(eq, pars, [kd], language='fortran')
    write(outdir, "qgs_model.f90", fortran_code)

    # The AUTO-07p target: the Fortran model file (PAR declarations and an
    # STPNT initial point) and the c.* configuration file.
    auto_main, auto_conf = equation_as_function(eq, pars, [kd],
                                                language='auto')
    write(outdir, "qgs_auto.f90", auto_main)
    write(outdir, "c.qgs_auto", auto_conf)
    print("wrote qgs_model.f90, qgs_auto.f90, c.qgs_auto")
    return dict(python=python_code, fortran=fortran_code,
                auto_main=auto_main, auto_conf=auto_conf)


if __name__ == "__main__":
    cli(main)
