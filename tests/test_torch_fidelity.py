"""The CPU counterpart of ``chip_smoke.py`` phase 13, the port's
long-horizon climate gate:

(a) the gate's helpers in ``chip_smoke.py`` (``climate_stats``,
    ``psd_peak``, ``compare_climate``, ``check_metrics``; the port's own
    copies, since the script imports nothing of the JAX package or of
    ``benchmarks/``) give metrics equal, bit for bit, to
    ``benchmarks/fidelity.py``'s on the same seeded arrays, and break the
    same tolerances: one pair of arrays meets them all, and one breaks
    each;
(b) the port's plain float64 and twofloat integrators on the CPU, over
    2,000 steps of dt 0.1 (a record every 10) from 4 attractor members of
    the port's native oracle (``attractor_ensemble`` with a 20,000-step
    transient), against the oracle's trajectories and against the JAX
    package's ``integrate_runge_kutta`` and ``integrate_runge_kutta_df``
    from the same members, at the gate's pointwise tolerance (rtol 5e-7,
    atol 5e-9) on every record, and the gate's climate tolerances.  These
    skip only where there is no ``g++`` to build the oracle with.
"""

import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from benchmarks import fidelity as jax_fidelity
from qgs_tpu.integrators.rk import integrate_runge_kutta as jax_integrate
from qgs_tpu.integrators.rk import (
    integrate_runge_kutta_df as jax_integrate_df,
)
from qgs_tpu.models.tendencies import create_tendencies as jax_create_tendencies
from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator
from qgs_tpu_torch.models.tendencies import create_tendencies

from tests.test_torch_host import both_params, maooam

STEPS, WRITE, MEMBERS = 2000, 10, 4
TOL = chip_smoke.TOL_FIDELITY_POINTWISE


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread (the suite's workers would
    oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) the helpers against benchmarks/fidelity.py
# ---------------------------------------------------------------------------

def _records(seed, shift=0., scale=1., bin_=25):
    """(4, 600, 6) records: seeded noise, a sinusoid in variable 0 at
    ``bin_`` of the 600-record window, then variable 2 scaled and shifted."""
    rng = np.random.default_rng(seed)
    recs = rng.standard_normal((4, 600, 6))
    recs[:, :, 0] += 5 * np.sin(2 * np.pi * bin_ * np.arange(600) / 600)
    recs[:, :, 2] = recs[:, :, 2] * scale + shift
    return recs


# case: (device records, the tolerance it breaks, None for none)
CASES = {
    "meets_all": (_records(2), None),
    "mean": (_records(2, shift=0.5), "mean deviation"),
    "std_low": (_records(2, scale=0.5), "< 0.8"),
    "std_high": (_records(2, scale=2.0), "> 1.25"),
    "psd": (_records(2, bin_=40), "PSD bin"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_helpers_equal_the_benchmarks(case):
    oracle = _records(1)
    device, broken = CASES[case]
    for a, b in zip(chip_smoke.climate_stats(device),
                    jax_fidelity.climate_stats(device)):
        assert np.array_equal(a, b)
    assert chip_smoke.psd_peak(device) == jax_fidelity.psd_peak(device)
    metrics = chip_smoke.compare_climate(oracle, device)
    assert metrics == jax_fidelity.compare_climate(oracle, device,
                                                   verbose=False)
    found = chip_smoke.check_metrics(metrics)
    if broken is None:
        assert found == []
        jax_fidelity.check_metrics(metrics)
    else:
        assert len(found) == 1 and broken in found[0], found
        with pytest.raises(AssertionError):
            jax_fidelity.check_metrics(metrics)


# ---------------------------------------------------------------------------
# (b) the port's integrators against the native oracle and the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def climate():
    """MAOOAM in both packages, 4 attractor members of the port's oracle,
    and the oracle's records of ``STEPS`` steps from them."""
    if shutil.which("g++") is None:
        pytest.skip("the native oracle needs g++")
    jax_pars, pars = both_params(maooam)
    f_j, _, qgt_j = jax_create_tendencies(jax_pars, return_qgtensor=True)
    f_p, _, qgt_p = create_tendencies(pars, return_qgtensor=True,
                                      device="cpu")
    ics = chip_smoke.attractor_ensemble(qgt_p.tensor, pars.ndim, MEMBERS,
                                        transient_steps=20_000)
    oracle = chip_smoke.run_oracle(qgt_p.tensor, ics, STEPS, WRITE)
    return dict(f_j=f_j, qgt_j=qgt_j, f_p=f_p, ics=ics, oracle=oracle)


def _port_records(climate, precision):
    integ = RungeKuttaIntegrator(precision=precision)
    integ.set_func(climate["f_p"])
    integ.integrate(0., STEPS * 0.1, 0.1, ic=climate["ics"],
                    write_steps=WRITE)
    t, traj = integ.get_trajectories()
    return t, torch.movedim(traj, -1, 1).numpy()


def _jax_records(climate, precision):
    if precision == "twofloat":
        t, traj = jax_integrate_df(climate["qgt_j"].tensor, 0.,
                                   STEPS * 0.1, 0.1, climate["ics"],
                                   write_steps=WRITE, squeeze=False)
    else:
        t, traj = jax_integrate(climate["f_j"].batched, 0., STEPS * 0.1,
                                0.1, climate["ics"], write_steps=WRITE,
                                squeeze=False)
    return t, np.moveaxis(np.asarray(traj), -1, 1)


@pytest.mark.parametrize("precision", ["float64", "twofloat"])
def test_integrator_against_the_native_oracle(climate, precision):
    t, recs = _port_records(climate, precision)
    oracle = climate["oracle"]
    assert recs.shape == oracle.shape == (MEMBERS, STEPS // WRITE + 1, 36)
    assert np.isfinite(recs).all()
    np.testing.assert_allclose(recs, oracle, **TOL)
    assert chip_smoke.check_metrics(
        chip_smoke.compare_climate(oracle, recs)) == []


@pytest.mark.parametrize("precision", ["float64", "twofloat"])
def test_integrator_against_the_jax_package(climate, precision):
    t_p, recs = _port_records(climate, precision)
    t_j, ref = _jax_records(climate, precision)
    assert np.array_equal(t_p, t_j)
    np.testing.assert_allclose(recs, ref, **TOL)
