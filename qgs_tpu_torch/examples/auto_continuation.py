"""AUTO-07p continuation export end to end: generate the Fortran model
file and the c.* configuration file, look into them, and hold the
generated code against the numeric tendencies on the device (counterpart
of ``examples/auto_continuation.py``)."""

import numpy as np

from qgs_tpu_torch.examples import cli
from qgs_tpu_torch.examples.symbolic_export import params, write
from qgs_tpu_torch.functions.symbolic_tendencies import (
    create_symbolic_tendencies, equation_as_function)
from qgs_tpu_torch.models.tendencies import create_tendencies

BOUND = 1e-8             # generated code against the numeric tendencies
# the numeric tendencies on two devices, at a random state
TOLERANCES = {"fx_num": dict(rtol=1e-12, atol=1e-14)}


def main(device="cuda", short=False, plot=True, outdir="."):
    # nothing is drawn and no length to cut: the common call's arguments
    # Continuation studies ask how the fixed points and periodic orbits
    # move as a parameter varies.  AUTO-07p answers that but needs the RHS
    # as Fortran with the continuation parameters left symbolic: a small
    # RP atmosphere on the symbolic path, k_d (surface friction) free.
    pars = params()
    kd = pars.atmospheric_params.kd

    # One symbolic build of the equations: as python (for the check
    # below) and as the 'auto' target's two files, the Fortran model file
    # (FUNC/STPNT with PAR(1) = k_d) and the AUTO constants file.
    python_code, eq = create_symbolic_tendencies(
        pars, continuation_variables=[kd], language='python',
        return_symbolic_eqs=True)
    auto_main, auto_conf = equation_as_function(eq, pars, [kd],
                                                language='auto')
    write(outdir, "qgs_auto.f90", auto_main)
    write(outdir, "c.qgs_auto", auto_conf)
    print("wrote qgs_auto.f90 "
          f"({len(auto_main.splitlines())} lines) and c.qgs_auto "
          f"({len(auto_conf.splitlines())} lines)")

    # the FUNC subroutine holds the 20 evolution equations, k_d as PAR(1)
    lines = auto_main.splitlines()
    head = next(i for i, ln in enumerate(lines) if 'SUBROUTINE FUNC' in ln)
    print("--- qgs_auto.f90: FUNC subroutine (excerpt) ---")
    print("\n".join(lines[head:head + 14]))
    eq1 = next(ln for ln in lines if ln.strip().startswith('F(1)'))
    print("...")
    print(eq1[:110] + " ...")
    # STPNT initializes the start point; the constants file carries NDIM
    # and the continuation-parameter list ICP
    stpnt = next(i for i, ln in enumerate(lines)
                 if 'SUBROUTINE STPNT' in ln)
    print("--- qgs_auto.f90: STPNT subroutine (excerpt) ---")
    print("\n".join(lines[stpnt:stpnt + 10]))
    print("--- c.qgs_auto ---")
    print(auto_conf)

    # To run the continuation with an AUTO-07p installation:
    #     auto
    #     AUTO> r = run('qgs_auto')        # reads qgs_auto.f90 + c.qgs_auto
    #     AUTO> plot(r)

    # Validation: exec the python form of the same equations and compare
    # it with the numeric tendencies on the device at a random state.
    # Code generation and the numeric path share nothing past the symbolic
    # tensor, so agreement checks the emitted equations end to end.
    ns = {'np': np}
    exec(python_code, ns)
    f_gen = ns['f']
    f_num, _ = create_tendencies(pars, device=device)
    x0 = np.random.default_rng(0).random(pars.ndim) * 0.1
    fx_gen = np.asarray(f_gen(0.0, x0, float(kd)), dtype=float)
    fx_num = f_num(0.0, x0)              # a NumPy state gives NumPy
    err = float(np.abs(fx_gen - fx_num).max())
    print(f"generated-code tendencies vs numeric pipeline: max |diff| = "
          f"{err:.2e}")
    if not err < BOUND:
        raise RuntimeError(f"generated code and f differ by {err:.2e}")
    return dict(auto_main=auto_main, auto_conf=auto_conf, fx_gen=fx_gen,
                fx_num=fx_num, err=err)


if __name__ == "__main__":
    cli(main)
