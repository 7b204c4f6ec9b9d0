"""The one route of the fused RK4 kernels: ``fused_route`` returns the kernel
family (``KernelFamily``) whose launch plan has a kernel, and every caller
launches through that family.

On the CPU, with the route patched to return each family (K1 for a rank-3
``Tendency``, K2 for a rank-3 ``DfTendency`` and K5 for a rank-5
``Tendency``) and ``KernelFamily.launch`` replaced by a recorder that runs
the plain version: ``integrate_runge_kutta`` (``integrate_runge_kutta_df``
for K2's double-float state) and ``forward_boundary_states`` each launch
once, through the returned family, with its tendency; and what they build
from the launch equals the plain step loop's result bit for bit."""

import numpy as np
import pytest
import torch

from qgs_tpu_torch.integrators import rk
from qgs_tpu_torch.ops import fused_df_rk4, fused_rk4, fused_rk4_quartic
from qgs_tpu_torch.ops.contraction import Tendency
from qgs_tpu_torch.ops.twofloat import DfTendency, df_from_f64
from qgs_tpu_torch.toolbox import lyapunov

from tests.test_torch_rk4_quartic import random_rank5


def quadratic(n1=8, nnz=40, seed=0):
    """A random rank-3 COO tensor over ``n1``: constant, linear and
    quadratic entries, and a damping ``-x_i`` on every row."""
    rng = np.random.default_rng(seed)
    trail = np.sort(rng.integers(0, n1, (2, nnz)), axis=0)
    diag = np.arange(1, n1)
    coords = np.concatenate([np.stack([rng.integers(1, n1, nnz), *trail]),
                             np.stack([diag, diag, 0 * diag])], axis=1)
    data = np.concatenate([rng.standard_normal(nnz) * 0.1, -np.ones(n1 - 1)])
    return coords, data, (n1,) * 3


def tendency(name):
    """The family's name, and a tendency module it takes."""
    if name == "K2":
        return fused_df_rk4.DF, DfTendency(*quadratic(), device="cpu")
    if name == "K5":
        t = random_rank5(4, n1=8, nnz=60)
        return fused_rk4_quartic.K5, Tendency(t.coords, t.data, t.shape,
                                              device="cpu")
    return fused_rk4.K1, Tendency(*quadratic(), device="cpu")


@pytest.fixture
def launches(monkeypatch):
    """The recorded launches, ``(family, tendency)``; each runs the plain
    version."""
    seen = []

    def launch(self, f, y, dts, write_every=0, kernel=None):
        seen.append((self, f))
        if isinstance(y, tuple):
            return fused_df_rk4.fused_df_rk4_reference(f, *y, dts,
                                                       write_every)
        return fused_rk4.fused_rk4_reference(f, y, dts, write_every)

    monkeypatch.setattr(fused_rk4.KernelFamily, "launch", launch)
    return seen


def route_to(monkeypatch, family):
    """``fused_route``, where the integrators and the toolbox read it,
    returning ``family``."""
    for module in (rk, lyapunov):
        monkeypatch.setattr(module, "fused_route", lambda f, y, tab: family)


def run(entry, f, x):
    """``entry`` of ``f`` from the float64 states ``x``: the integrator's
    trajectory, or the forward pass's boundary states."""
    if entry == "integrate":
        integrate = (rk.integrate_runge_kutta_df
                     if isinstance(f, DfTendency)
                     else rk.integrate_runge_kutta)
        return integrate(f, 0., 0.52, 0.05, x, write_steps=3)[1]
    y = df_from_f64(torch.as_tensor(x)) if isinstance(f, DfTendency) \
        else torch.as_tensor(x)
    return lyapunov.forward_boundary_states(f, y, 3, 2, 0.05)


@pytest.mark.parametrize("entry", ["integrate", "forward"])
@pytest.mark.parametrize("name", ["K1", "K2", "K5"])
def test_callers_launch_through_the_routed_family(name, entry, launches,
                                                  monkeypatch):
    family, f = tendency(name)
    x = np.random.default_rng(5).random((3, f.shape[0] - 1)) * 0.1
    want = run(entry, f, x)               # the plain step loop
    assert launches == []
    route_to(monkeypatch, family)
    got = run(entry, f, x)
    assert len(launches) == 1
    assert launches[0][0] is family and launches[0][1] is f
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)
