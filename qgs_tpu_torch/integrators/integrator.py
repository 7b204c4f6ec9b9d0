"""
Ensemble integrator class
=========================

Counterpart of :class:`qgs_tpu.integrators.integrator.RungeKuttaIntegrator`
and :class:`~qgs_tpu.integrators.integrator.RungeKuttaTglsIntegrator`: the
reference API surface (``set_func`` / ``set_bca`` / ``initialize`` /
``integrate`` / ``get_trajectories``) over a batched integration
(:func:`qgs_tpu_torch.integrators.rk.integrate_runge_kutta`, or
:func:`~qgs_tpu_torch.integrators.rk.integrate_runge_kutta_df` for
``precision='twofloat'``; the TGLS counterparts for the coupled
trajectory-tangent system) whose ensemble is split over a device mesh
(:mod:`qgs_tpu_torch.parallel.mesh`), by default every visible card.
"""

from __future__ import annotations

import numpy as np
import torch

from qgs_tpu_torch.integrators.rk import (
    infer_ndim, integrate_runge_kutta, integrate_runge_kutta_df,
    integrate_runge_kutta_tgls, integrate_runge_kutta_tgls_df, merge_tableau,
    resolve_device, rk4_tableau,
)
from qgs_tpu_torch.ops.twofloat import DfTangent, DfTendency
from qgs_tpu_torch.parallel.mesh import ensemble_mesh


def same_model_jacobian(fjac, qgt):
    """True when ``fjac`` derives from the same model as the tensor object
    ``qgt``: the same object, or value-equal Jacobian tensors (a rebuild
    from identical parameters).  A plain callable (no ``.qgtensor``) counts
    as custom."""
    other = getattr(fjac, "qgtensor", None)
    if other is qgt:
        return True
    if other is None:
        return False
    a, b = other.jacobian_tensor, qgt.jacobian_tensor
    return (tuple(a.shape) == tuple(b.shape)
            and np.array_equal(a.coords, b.coords)
            and np.array_equal(a.data, b.data))


class RungeKuttaIntegrator:
    """Ensemble Runge-Kutta integrator.

    Parameters
    ----------
    num_threads: int, optional
        Kept for API compatibility and ignored: parallelism is the device
        mesh.
    b, c, a: arrays, optional
        Butcher tableau (default RK4).
    number_of_dimensions: int, optional
        State dimension (inferred from the first integration otherwise).
    precision: str, optional
        'float64' (default) integrates in the dtype of the tendency function
        it is given: build the tendencies with ``dtype=torch.float32`` for a
        float32 run.  'twofloat' integrates in double-float (pairs of
        float32, about 48 bits of mantissa) with float64 initial conditions
        and trajectories; it needs a tendency function made by
        :func:`~qgs_tpu_torch.models.tendencies.create_tendencies` (its
        ``.qgtensor`` carries the tensor) and takes any explicit tableau.

    device: str or torch.device, optional
        The device for a tendency function that carries none (a plain
        callable); default ``"cuda"``.
    mesh: :class:`~qgs_tpu_torch.parallel.mesh.Mesh`, optional
        The devices to split the ensemble over (see :attr:`mesh`).

    The integration runs on the device of the tendency function (else of a
    tensor ``ic``, else ``device``); the trajectories returned by
    :meth:`get_trajectories` stay there.  An ensemble of at least as many
    members as the mesh has ensemble entries, on a mesh of more than one, is
    split over the mesh instead: each shard runs on its device with a copy
    of the tendency there (made once per device and function), and the
    trajectories end up on the mesh's first device.
    """

    def __init__(self, num_threads=None, b=None, c=None, a=None,
                 number_of_dimensions=None, precision="float64",
                 device=None, mesh=None):
        if precision not in ("float64", "twofloat"):
            raise ValueError(
                f"unknown precision {precision!r}: expected 'float64' (the "
                "tendency function's dtype) or 'twofloat'; for a float32 run, "
                "build the tendencies with dtype=torch.float32")
        tab = merge_tableau(a, b, c)
        self.a, self.b, self.c = tab if tab is not None else rk4_tableau()
        self.func = None
        self.n_dim = number_of_dimensions
        self.ic = None
        self._time = None
        self._recorded_traj = None
        self.precision = precision
        self._qgtensor = None
        self._df_func = None
        self.device = device
        self._mesh = mesh
        self._card_mesh = None

    # -- configuration -----------------------------------------------------

    @property
    def mesh(self):
        """The mesh the ensemble is split over: the one given, else every
        visible card when the tendency function runs on a card, else its
        one device."""
        return self._mesh_for(None)

    def _mesh_for(self, ic):
        """The mesh given, else every visible card
        (:func:`~qgs_tpu_torch.parallel.mesh.ensemble_mesh`, built once)
        when the integration of ``ic`` runs on a card, else the one device
        it runs on (:func:`~qgs_tpu_torch.integrators.rk.resolve_device`),
        so that a CPU integration never touches CUDA."""
        if self._mesh is not None:
            return self._mesh
        dev = resolve_device(self.func, ic, self.device)
        if dev.type != "cuda":
            return ensemble_mesh([dev])
        if self._card_mesh is None:
            self._card_mesh = ensemble_mesh()
        return self._card_mesh

    def set_func(self, f, ic_init=True):
        """Set the tendency function (single-state with ``.batched``, or
        batched)."""
        self.func = getattr(f, "batched", f)
        self._qgtensor = getattr(f, "qgtensor", None)
        self._df_func = None
        if ic_init:
            self.ic = None

    def set_bca(self, b=None, c=None, a=None, ic_init=True):
        """Change the Butcher tableau (partial updates keep the other
        coefficients)."""
        self.a, self.b, self.c = merge_tableau(
            a, b, c, current=(self.a, self.b, self.c))
        if ic_init:
            self.ic = None

    def start(self):
        """No-op (kept for API compatibility: there is no worker pool)."""

    def terminate(self):
        """No-op (kept for API compatibility)."""

    stop = terminate

    def _df_tendency(self):
        """The double-float tendency of the model, on the tendency
        function's device (built once per ``set_func``).  The twofloat tier
        runs the model's tensor, so the function must carry one."""
        if self._qgtensor is None:
            raise RuntimeError(
                "precision='twofloat' needs a tendency function from "
                "create_tendencies (carrying its .qgtensor): the double-float "
                "step runs the model's tensor, and a plain callable would be "
                "silently ignored")
        if self._df_func is None:
            device = getattr(self.func, "device", self.device)
            if device is None:
                raise RuntimeError(
                    "precision='twofloat' runs on the tendency function's "
                    "device, and this function carries none: build it with "
                    "create_tendencies, or pass device= to the integrator")
            t = self._qgtensor.tensor
            self._df_func = DfTendency(t.coords, t.data, t.shape,
                                       device=device)
        return self._df_func

    # -- attractor initialization ------------------------------------------

    def initialize(self, convergence_time, dt, pert_size=0.01,
                   reconvergence_time=None, forward=True,
                   number_of_trajectories=1, ic=None, reconverge=False,
                   rng=None):
        """Spin an ensemble of initial conditions onto the attractor.

        Random initial states are drawn from ``rng``, a
        :class:`numpy.random.Generator`, which is required when ``ic`` is
        not given.  With ``reconverge``, one long transient produces a
        converged state which is then perturbed into the full ensemble and
        re-converged for ``reconvergence_time``.
        """
        if ic is None:
            if rng is None:
                raise ValueError("initialize without ic draws random initial "
                                 "states: pass rng=np.random.default_rng(seed)")
            if self.n_dim is None:
                self.n_dim = infer_ndim(self.func, self.device)
            if (reconverge and reconvergence_time is not None
                    and number_of_trajectories > 1):
                seed_ic = rng.standard_normal(self.n_dim)
                self.integrate(0., convergence_time, dt, ic=seed_ic,
                               write_steps=0, forward=forward)
                _, x0 = self.get_trajectories()
                perts = pert_size * rng.standard_normal(
                    (number_of_trajectories, self.n_dim))
                ics = x0[None, :] + torch.as_tensor(perts).to(x0)
                self.integrate(0., reconvergence_time, dt, ic=ics,
                               write_steps=0, forward=forward)
                _, x = self.get_trajectories()
                self.ic = torch.atleast_2d(x)
                return
            tmp_ic = rng.standard_normal((number_of_trajectories, self.n_dim))
        else:
            tmp_ic = ic

        self.integrate(0., convergence_time, dt, ic=tmp_ic, write_steps=0,
                       forward=forward)
        _, x = self.get_trajectories()
        self.ic = torch.atleast_2d(x)

    # -- integration -------------------------------------------------------

    def integrate(self, t0, t, dt, ic=None, forward=True, write_steps=1):
        """Integrate the ensemble; results retrieved via
        :meth:`get_trajectories`.  ``ic`` (array or tensor, (ndim,) or
        (B, ndim)) is cast to the tendency function's dtype and device."""
        if self.func is None:
            raise RuntimeError("set_func must be called first")
        if ic is None:
            ic = self.ic
        if ic is None:
            raise ValueError("no initial conditions available")
        if not torch.is_tensor(ic):
            ic = np.asarray(ic, dtype=np.float64)
        self.n_dim = ic.shape[-1]
        mesh = self._mesh_for(ic)

        if self.precision == "twofloat":
            time, traj = integrate_runge_kutta_df(
                self._df_tendency(), t0, t, dt, ic, forward=forward,
                write_steps=write_steps, squeeze=False, a=self.a, b=self.b,
                c=self.c, mesh=mesh)
        else:
            time, traj = integrate_runge_kutta(
                self.func, t0, t, dt, ic, forward=forward,
                write_steps=write_steps, b=self.b, c=self.c, a=self.a,
                squeeze=False, device=self.device, mesh=mesh)
        self._time = time
        self._recorded_traj = traj.squeeze()

    def get_trajectories(self):
        """Return ``(time, trajectories)`` of the last integration: times as
        a NumPy array, trajectories a tensor on the integration's device.
        On a mesh that spans processes, the shards of the other processes
        were all-gathered at the end of :meth:`integrate` (which every
        process must call)."""
        return self._time, self._recorded_traj

    def get_ic(self):
        """Return the stored initial conditions (set by :meth:`initialize`)."""
        return self.ic

    def set_ic(self, ic):
        self.ic = torch.atleast_2d(torch.as_tensor(ic))


class RungeKuttaTglsIntegrator(RungeKuttaIntegrator):
    """Ensemble integrator of the coupled (trajectory, tangent) system, with
    the adjoint, inverse and boundary options (ref ``integrator.py:515-1296``),
    through :func:`~qgs_tpu_torch.integrators.rk.integrate_runge_kutta_tgls`
    or, for ``precision='twofloat'``,
    :func:`~qgs_tpu_torch.integrators.rk.integrate_runge_kutta_tgls_df`.

    The twofloat tier runs the model's tensors, so it needs a tendency
    function from ``create_tendencies`` and a Jacobian of the same model; a
    custom ``fjac`` or a ``boundary`` term raises there."""

    def __init__(self, *args, **kwargs):
        RungeKuttaIntegrator.__init__(self, *args, **kwargs)
        self.func_jac = None
        self.tg_ic = None
        self._recorded_fmatrix = None
        self._df_tangent = None

    def set_func(self, f, fjac=None, ic_init=True):
        """Set the tendency function and its Jacobian (single-state with
        ``.batched``, or batched).  The model's tensors are kept (for the
        twofloat tier) only when ``fjac`` derives from the same model, by
        value equality of the Jacobian tensors."""
        self.func = getattr(f, "batched", f)
        qgt = getattr(f, "qgtensor", None)
        if fjac is not None:
            self.func_jac = getattr(fjac, "batched", fjac)
            if qgt is not None and not same_model_jacobian(fjac, qgt):
                qgt = None
        self._qgtensor = qgt
        self._df_func = self._df_tangent = None
        if ic_init:
            self.ic = None

    def _check_twofloat(self, boundary):
        if self._qgtensor is None:
            raise RuntimeError(
                "precision='twofloat' needs a tendency function from "
                "create_tendencies (carrying its .qgtensor) and a Jacobian "
                "derived from the same model: the double-float step runs the "
                "model's tensors, and a custom fjac would be silently ignored")
        if boundary is not None:
            raise ValueError("precision='twofloat' does not support a "
                             "boundary term")

    def _df_pair(self):
        """The double-float tendency and tangent contraction of the model,
        built once per ``set_func``."""
        f_df = self._df_tendency()
        if self._df_tangent is None:
            jt = self._qgtensor.jacobian_tensor
            self._df_tangent = DfTangent(jt.coords, jt.data, jt.shape,
                                         device=f_df.device)
        return f_df, self._df_tangent

    def integrate(self, t0, t, dt, ic=None, tg_ic=None, forward=True,
                  adjoint=False, inverse=False, boundary=None, write_steps=1):
        """Integrate the ensemble and its tangent blocks; results retrieved
        via :meth:`get_trajectories`.  ``tg_ic`` defaults to the stored one,
        else the identity."""
        if self.func is None or self.func_jac is None:
            raise RuntimeError("set_func(f, fjac) must be called first")
        if ic is None:
            ic = self.ic
        if ic is None:
            raise ValueError("no initial conditions available")
        if not torch.is_tensor(ic):
            ic = np.asarray(ic, dtype=np.float64)
        single = ic.ndim == 1
        self.n_dim = ic.shape[-1]
        if tg_ic is None:
            tg_ic = (self.tg_ic if self.tg_ic is not None
                     else np.eye(self.n_dim))

        mesh = self._mesh_for(ic)
        if self.precision == "twofloat":
            self._check_twofloat(boundary)
            time, traj, fmat = integrate_runge_kutta_tgls_df(
                *self._df_pair(), t0, t, dt, ic, tg_ic, forward=forward,
                adjoint=adjoint, inverse=inverse, write_steps=write_steps,
                a=self.a, b=self.b, c=self.c, mesh=mesh)
        else:
            time, traj, fmat = integrate_runge_kutta_tgls(
                self.func, self.func_jac, t0, t, dt, ic, tg_ic,
                forward=forward, adjoint=adjoint, inverse=inverse,
                boundary=boundary, write_steps=write_steps, b=self.b,
                c=self.c, a=self.a, device=self.device, mesh=mesh)
        self._time = time
        self._recorded_traj = traj.squeeze() if single else traj
        self._recorded_fmatrix = fmat.squeeze() if single else fmat

    def get_tg_ic(self):
        """Return the stored tangent-linear initial conditions."""
        return self.tg_ic

    def set_tg_ic(self, tg_ic):
        """Set the tangent-linear initial conditions: 1-D (one perturbation,
        broadcast over the ensemble), 2-D (per-trajectory, or a matrix of
        perturbations) or 3-D (per-trajectory matrices)."""
        self.tg_ic = (tg_ic if torch.is_tensor(tg_ic)
                      else np.asarray(tg_ic, dtype=np.float64))

    def get_trajectories(self):
        """Return ``(time, trajectories, fundamental_matrices)``: times as a
        NumPy array, the others tensors on the integration's device."""
        return self._time, self._recorded_traj, self._recorded_fmatrix
