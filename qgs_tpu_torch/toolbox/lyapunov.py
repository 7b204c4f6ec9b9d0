"""
Lyapunov toolbox
================

Counterpart of :mod:`qgs_tpu.toolbox.lyapunov`: backward and forward
Lyapunov vectors and exponents (Benettin QR algorithm) and covariant
Lyapunov vectors (Ginelli et al. 2007, and the BLV/FLV subspace
intersection), over a batch of trajectories at once.

* A Benettin window is ``n_sub = dt / mdt`` TGLS substeps of the coupled
  (trajectory, tangent) system followed by one batched QR of the (B, n,
  n_vec) tangent block (:func:`make_window_step`); the JAX package's nested
  ``lax.scan`` becomes Python loops over windows and substeps.
* ``precision='twofloat'`` propagates the windows in double-float
  (:func:`make_window_step_df`) and orthonormalizes in native float64.
* The forward-trajectory pass of the forward vectors is one launch of the
  fused RK4 kernel on a CUDA state of a rank-3 model
  (:func:`forward_boundary_states`).
* Device: every function runs on ``f``'s ``.device``, else the device of a
  tensor ``ic``, else ``device`` (default ``"cuda"``), and returns tensors
  there; without a card the default raises.  ``mesh=`` splits the ensemble
  over a device mesh (:mod:`qgs_tpu_torch.parallel.mesh`), the shards run
  one after another, each on its device, and the results are concatenated
  on the mesh's first device.

Conventions: ``dt`` must be an integer multiple of ``mdt`` and every span an
integer multiple of ``dt``.  Shapes: trajectories (B, n); vector blocks (B,
n, n_vec); outputs (B, n, [n_vec,] n_records), squeezed.
"""

from __future__ import annotations

import numpy as np
import torch

from qgs_tpu_torch.integrators.integrator import same_model_jacobian
from qgs_tpu_torch.integrators.rk import (
    _is_rk4, as_state, fused_route, make_rk_step, make_tgls_step,
    merge_tableau, rk4_tableau,
)
from qgs_tpu_torch.ops.contraction import make_bucketed_tangent
from qgs_tpu_torch.ops.twofloat import (
    DfTangent, DfTendency, _check_explicit_tableau, df_from_f64, df_to_f64,
    make_df_rk4_step, make_df_rk_step_dynamic, make_df_tgls_rk4_step,
    make_df_tgls_rk_step_dynamic,
)
from qgs_tpu_torch.parallel.mesh import map_shards


def _n_windows(t0, t1, dt):
    n = int(round((t1 - t0) / dt))
    if abs(n * dt - (t1 - t0)) >= 1e-9 * max(1.0, abs(t1 - t0)):
        raise ValueError(f"span [{t0}, {t1}] must be an integer multiple of "
                         f"dt = {dt}")
    return n


def _n_sub(dt, mdt):
    n = int(round(dt / mdt))
    if abs(n * mdt - dt) >= 1e-12 + 1e-9 * dt:
        raise ValueError(f"dt = {dt} must be a multiple of mdt = {mdt}")
    return n


def _normalize_columns(m):
    """Normalize matrix columns; return ``(normalized, norms)``."""
    norms = torch.linalg.norm(m, dim=-2)
    return m / norms[..., None, :], norms


def _cholqr(m):
    """One Cholesky-QR pass: ``m = Q R`` with ``R^T R = m^T m``."""
    L = torch.linalg.cholesky(m.mT @ m)                 # g = L L^T, R = L^T
    q = torch.linalg.solve_triangular(L, m.mT, upper=False).mT
    return q, L.mT


def batched_qr(m, method="auto"):
    """Batched thin QR of ``(..., n, k)`` stacks for the Benettin windows.

    ``'householder'`` (and ``'auto'``, as in the JAX package) is
    :func:`torch.linalg.qr`; ``'cholqr2'`` runs two Cholesky-QR passes
    (orthogonal to machine precision for the well-conditioned blocks a QR
    cadence gives) and fixes ``diag(R) > 0``.  Householder may flip column
    signs; the exponents use ``log|diag R|`` either way."""
    if method in ("auto", "householder"):
        return torch.linalg.qr(m)
    if method != "cholqr2":
        raise ValueError(f"unknown QR method {method!r}: expected 'auto', "
                         "'householder' or 'cholqr2'")
    q1, r1 = _cholqr(m)
    q, r2 = _cholqr(q1)
    return q, r2 @ r1


def _log_diag(R, dt):
    """``log|diag R| / dt``: a window's local exponents."""
    return torch.log(torch.abs(torch.diagonal(R, dim1=-2, dim2=-1))) / dt


def make_window_step(f, fjac, dt, mdt, tableau=None, adjoint=False,
                     inverse=False, backward=False, qr_method="auto",
                     tangent=None):
    """One Benettin window ``window((y, Q), tt) -> ((y', Q'), R)``: ``n_sub``
    TGLS substeps of ``mdt`` (of ``-mdt`` with ``backward``) from ``tt``,
    then the QR of the propagated block.  ``tangent`` is a direct tangent
    contraction (:class:`~qgs_tpu_torch.ops.contraction.Tangent`, carrying
    the adjoint/inverse transform) used in place of the materialized
    Jacobian."""
    a, b, c = tableau if tableau is not None else rk4_tableau()
    n_sub = _n_sub(dt, mdt)
    h = -mdt if backward else mdt
    step = make_tgls_step(f, fjac, a, b, c, adjoint=adjoint, inverse=inverse,
                          tangent=tangent)

    def window(carry, tt):
        for k in range(n_sub):
            carry = step(carry, tt + k * h, h)
        y2, M = carry
        Q, R = batched_qr(M, qr_method)
        return (y2, Q), R

    return window


def make_window_step_df(f, tangent, dt, mdt, adjoint=False, inverse=False,
                        backward=False, qr_method="auto", tableau=None):
    """Double-float Benettin window over the pair carry ``((y_hi, y_lo),
    (Q_hi, Q_lo))``: the substeps in double-float (``f`` a
    :class:`~qgs_tpu_torch.ops.twofloat.DfTendency`, ``tangent`` a
    :class:`~qgs_tpu_torch.ops.twofloat.DfTangent` that ``adjoint`` and
    ``inverse`` transform further; RK4 with ``mdt`` baked in, or any
    explicit tableau), then the exact conversion to float64, a native
    float64 QR (``'auto'`` is Householder, as the JAX package picks off the
    TPU) and the split of Q back into a pair.  R is float64.

    ``qr_method='mixed'`` (the JAX package's mixed-precision ``cholqr_df``)
    exists only to avoid emulated float64 on the TPU and is not ported."""
    if qr_method == "mixed":
        raise NotImplementedError(
            "qr_method='mixed' (cholqr_df) is a workaround for the TPU's "
            "emulated float64 and is not ported: the card's float64 QR is "
            "native (ROADMAP section 1, TPU workarounds not carried)")
    n_sub = _n_sub(dt, mdt)
    h = -mdt if backward else mdt
    tangent = tangent.with_transform(adjoint, inverse)
    if tableau is None or _is_rk4(*tableau):
        step = make_df_tgls_rk4_step(f, tangent, h, tangent.device)
    else:
        dyn = make_df_tgls_rk_step_dynamic(f, tangent, *tableau)

        def step(carry):
            return dyn(carry, 0.0, h)

    def window(carry, tt):
        del tt                       # the model is autonomous
        for _ in range(n_sub):
            carry = step(carry)
        y2, M = carry
        Q64, R = batched_qr(df_to_f64(M), qr_method)
        return (y2, df_from_f64(Q64)), R

    return window


# ---------------------------------------------------------------------------
# set-up shared by the compute_* functions
# ---------------------------------------------------------------------------

def _check_df_args(tensors, tableau):
    if tensors is None:
        raise ValueError(
            "precision='twofloat' needs tensors=(tendency_tensor, "
            "jacobian_tensor), e.g. (f.qgtensor.tensor, "
            "f.qgtensor.jacobian_tensor) from create_tendencies")
    if tableau is not None:
        _check_explicit_tableau(*tableau)


def _window(f, fjac, dt, mdt, tableau, adjoint, inverse, backward,
            precision, tensors, y):
    """The compute_* functions' window: double-float for
    ``precision='twofloat'`` (its :class:`DfTendency` returned too), else
    the ambient dtype's, through a direct :class:`Tangent` when the model's
    tensors are known."""
    if precision == "twofloat":
        T, JT = tensors
        f_df = DfTendency(T.coords, T.data, T.shape, device=y.device)
        tangent = DfTangent(JT.coords, JT.data, JT.shape, device=y.device)
        return make_window_step_df(f_df, tangent, dt, mdt, adjoint, inverse,
                                   backward, tableau=tableau), f_df
    tangent = None
    if tensors is not None:
        tangent = make_bucketed_tangent(tensors[1], dtype=y.dtype,
                                        adjoint=adjoint, inverse=inverse,
                                        device=y.device)
    return make_window_step(f, fjac, dt, mdt, tableau, adjoint, inverse,
                            backward, tangent=tangent), None


def _start(f, ic, precision, tensors, tableau, device):
    """The initial state (float64 for twofloat), after the twofloat
    arguments' checks."""
    if precision == "twofloat":
        _check_df_args(tensors, tableau)
    return as_state(f, ic, device,
                    torch.float64 if precision == "twofloat" else None)


def _sharded(mesh, y, f, fjac, run):
    """``run(f, fjac, y, members)`` on the ensemble ``y`` (B, n), whole or
    shard by shard over the mesh
    (:func:`~qgs_tpu_torch.parallel.mesh.map_shards`), the tangent blocks
    starting from each shard's states.  ``members`` (a tensor) holds the
    indices in the batch of the shard's members (the padding repeats the
    last).  The shards run one after another; the times are the first
    shard's."""
    members = torch.arange(y.shape[0], device=y.device)
    return map_shards(mesh, (y, members), (f, fjac), lambda fns, ys: [
        run(fk, jk, yk, mk) for (fk, jk), (yk, mk) in zip(fns, ys)])


def _squeezed(out):
    """The outputs with their tensors squeezed (part by part in tuples), as
    the reference returns them."""
    return (out[0],) + tuple(
        tuple(p.squeeze() for p in x) if isinstance(x, tuple) else x.squeeze()
        for x in out[1:])


def _broadcast(a, y, B):
    """A host matrix as a (B, ...) tensor in ``y``'s dtype, on its device."""
    a = torch.as_tensor(a, dtype=y.dtype, device=y.device)
    return a[None].expand((B,) + tuple(a.shape))


def _record_index(n_rec, write_steps, last):
    """The recorded points among ``n_rec + 1``: every ``write_steps``-th and
    the last, or only ``last`` for ``write_steps == 0``."""
    if write_steps == 0:
        return np.array([last])
    idx = np.arange(0, n_rec + 1, write_steps)
    if idx[-1] != n_rec:
        idx = np.concatenate([idx, [n_rec]])
    return idx


def _to_f64(x, df_mode):
    return df_to_f64(x) if df_mode else x


def _outputs(times, ys, vecs, exps):
    """``(times, traj (B, n, T), exponents (B, n_vec, T), vectors (B, n,
    n_vec, T))`` from per-record lists (unsqueezed)."""
    stack = (lambda xs: torch.movedim(torch.stack(xs), 0, -1))
    return times, stack(ys), stack(exps), stack(vecs)


# ---------------------------------------------------------------------------
# Benettin: backward and forward Lyapunov vectors
# ---------------------------------------------------------------------------

def compute_backward_lyapunovs(f, fjac, t0, tw, t, dt, mdt, ic, n_vec=None,
                               write_steps=1, adjoint=False, inverse=False,
                               tableau=None, seed=0, precision=None,
                               tensors=None, device=None, mesh=None):
    """Backward Lyapunov vectors and exponents between ``tw`` and ``t`` after
    a convergence transient from ``t0`` to ``tw`` (Benettin QR algorithm).

    ``f`` and ``fjac`` are batched; ``ic`` is (B, n) or (n,).  With
    ``tensors=(T, JT)`` (the model's COO tendency and Jacobian tensors) the
    tangent runs through the direct contraction; ``precision='twofloat'``
    (which needs them) propagates in double-float with a float64 QR a
    window.  The exponent recorded at a window's start is that of the
    window before it (zero at ``tw``).  With a ``mesh`` the ensemble and
    its tangent blocks are split over it (:func:`_sharded`).  Returns
    ``(times, traj, exponents, vectors)`` shaped (B, n, T), (B, n_vec, T),
    (B, n, n_vec, T), squeezed."""
    y = _start(f, ic, precision, tensors, tableau, device)
    return _squeezed(_sharded(mesh, y, f, fjac, lambda fk, jk, yk, _: (
        _backward(fk, jk, t0, tw, t, dt, mdt, yk, n_vec, write_steps,
                  adjoint, inverse, tableau, seed, precision, tensors))))


def _backward(f, fjac, t0, tw, t, dt, mdt, y, n_vec, write_steps, adjoint,
              inverse, tableau, seed, precision, tensors):
    """:func:`compute_backward_lyapunovs` of the state ``y``, unsqueezed."""
    df_mode = precision == "twofloat"
    B, n = y.shape
    n_vec = n if n_vec is None else n_vec
    n_pre = _n_windows(t0, tw, dt)
    n_rec = _n_windows(tw, t, dt)

    rng = np.random.default_rng(seed)
    Q0 = _broadcast(np.linalg.qr(rng.random((n, n_vec)))[0], y, B)
    window, _ = _window(f, fjac, dt, mdt, tableau, adjoint, inverse, False,
                        precision, tensors, y)
    carry = (df_from_f64(y), df_from_f64(Q0)) if df_mode else (y, Q0)

    for tt in t0 + dt * np.arange(n_pre):
        carry, _ = window(carry, tt)
    idx = _record_index(n_rec, write_steps, n_rec)
    keep = set(idx.tolist())
    exps = torch.zeros((B, n_vec), dtype=torch.float64 if df_mode
                       else y.dtype, device=y.device)
    ys, vecs, ex = [], [], []
    for i in range(n_rec + 1):
        if i in keep:
            ys.append(_to_f64(carry[0], df_mode))
            vecs.append(_to_f64(carry[1], df_mode))
            ex.append(exps)
        if i < n_rec:
            carry, R = window(carry, tw + dt * i)
            exps = _log_diag(R, dt)
    times = tw + dt * np.arange(n_rec + 1)
    return _outputs(times[idx], ys, vecs, ex)


def forward_boundary_states(f, y, n_windows, n_sub, mdt, tableau=None):
    """The states at ``n_windows + 1`` window boundaries of a forward
    integration by ``n_windows * n_sub`` steps of ``mdt``: a (n_windows + 1,
    B, n) tensor, a pair of them for a double-float state ``y``.

    On a CUDA state, classical RK4 of a tendency that a fused kernel family
    takes is one launch of that family
    (:func:`~qgs_tpu_torch.integrators.rk.fused_route`: K1 for a rank-3
    :class:`~qgs_tpu_torch.ops.contraction.Tendency`, K2 for a rank-3
    :class:`~qgs_tpu_torch.ops.twofloat.DfTendency`, K5 for a rank-5
    ``Tendency``), a record every ``n_sub`` steps.  Every other case is the
    plain step loop (the double-float RK4 step with ``mdt`` baked in, as the
    JAX package's forward pass)."""
    df_mode = isinstance(y, tuple)
    rk4 = tableau is None or _is_rk4(*tableau)
    y0 = y[0] if df_mode else y
    family = fused_route(f, y, tableau if tableau is not None
                         else rk4_tableau())
    if family is not None:
        dts = torch.full((n_windows * n_sub,), float(mdt),
                         dtype=torch.float64, device=y0.device)
        _, recs = family.launch(f, y, dts, n_sub)
        if df_mode:
            return tuple(torch.cat([p[None], r]) for p, r in zip(y, recs))
        return torch.cat([y[None], recs])

    if df_mode:
        if rk4:
            step = make_df_rk4_step(f, mdt, y0.device)
        else:
            dyn = make_df_rk_step_dynamic(f, *tableau)

            def step(y2):
                return dyn(y2, 0.0, mdt)
    else:
        rk = make_rk_step(f, *(tableau if tableau is not None
                               else rk4_tableau()))

        def step(y2):
            return rk(y2, 0.0, mdt)
    states = [y]
    for _ in range(n_windows):
        for _ in range(n_sub):
            y = step(y)
        states.append(y)
    if df_mode:
        return tuple(torch.stack(p) for p in zip(*states))
    return torch.stack(states)


def compute_forward_lyapunovs(f, fjac, t0, tw, t, dt, mdt, ic, n_vec=None,
                              write_steps=1, adjoint=False, inverse=False,
                              tableau=None, seed=0, precision=None,
                              tensors=None, device=None, mesh=None):
    """Forward Lyapunov vectors and exponents between ``t0`` and ``tw``: the
    trajectory is integrated forward to ``t``
    (:func:`forward_boundary_states`), then the tangent flow is propagated
    backward with a QR every window, converging over [t, tw] and recording
    over [tw, t0].  The vectors come out in ascending-exponent order.
    Options and shapes as :func:`compute_backward_lyapunovs`."""
    y = _start(f, ic, precision, tensors, tableau, device)
    return _squeezed(_sharded(mesh, y, f, fjac, lambda fk, jk, yk, _: (
        _forward(fk, jk, t0, tw, t, dt, mdt, yk, n_vec, write_steps,
                 adjoint, inverse, tableau, seed, precision, tensors))))


def _forward(f, fjac, t0, tw, t, dt, mdt, y, n_vec, write_steps, adjoint,
             inverse, tableau, seed, precision, tensors):
    """:func:`compute_forward_lyapunovs` of the state ``y``, unsqueezed."""
    df_mode = precision == "twofloat"
    B, n = y.shape
    n_vec = n if n_vec is None else n_vec
    n_rec = _n_windows(t0, tw, dt)
    n_post = _n_windows(tw, t, dt)
    n_sub = _n_sub(dt, mdt)

    rng = np.random.default_rng(seed)
    Q = _broadcast(np.linalg.qr(rng.random((n, n_vec)))[0], y, B)
    window, f_df = _window(f, fjac, dt, mdt, tableau, adjoint, inverse,
                           True, precision, tensors, y)
    if df_mode:
        y, Q = df_from_f64(y), df_from_f64(Q)
    ys = forward_boundary_states(f_df if df_mode else f, y, n_rec + n_post,
                                 n_sub, mdt, tableau)

    def state(i):
        return tuple(p[i] for p in ys) if df_mode else ys[i]

    R = None
    for k, tt in enumerate(t - dt * np.arange(n_post)):
        (_, Q), R = window((state(n_rec + n_post - k), Q), tt)
    if R is None:
        R = torch.zeros((B, n_vec, n_vec), dtype=torch.float64 if df_mode
                        else y.dtype, device=ys[0].device)
    # records run backward in time, from tw (i = n_rec) down to t0 (i = 0)
    idx = _record_index(n_rec, write_steps, 0)
    keep = set(idx.tolist())
    recs = {}
    for i in range(n_rec, -1, -1):
        if i in keep:
            recs[i] = (_to_f64(state(i), df_mode), _to_f64(Q, df_mode),
                       -_log_diag(R, dt))
        if i > 0:
            (_, Q), R = window((state(i), Q), t0 + dt * i)
    times = t0 + dt * np.arange(n_rec + 1)
    return _outputs(times[idx], *zip(*(recs[i] for i in idx)))


# ---------------------------------------------------------------------------
# Covariant Lyapunov vectors
# ---------------------------------------------------------------------------

def compute_clvs_ginelli(f, fjac, t0, ta, tb, tc, dt, mdt, ic, n_vec=None,
                         write_steps=1, tableau=None, seed=0, noise_pert=0.0,
                         precision=None, tensors=None, device=None,
                         mesh=None):
    """Covariant Lyapunov vectors between ``ta`` and ``tb`` by the Ginelli
    method: a forward Benettin pass from ``t0`` storing R (and Q at the
    recorded points), then a backward pass of triangular solves from
    ``tc``.  Memory grows with the number of windows in [ta, tc].

    ``noise_pert`` regularizes near-tangencies: after every backward solve,
    Gaussian noise of that amplitude (drawn on the host from the seeded
    generator, so that 0 adds exact zeros) is added to the diagonal of the
    coefficient matrix before the columns are normalized (Kuptsov & Parlitz
    2012).  With ``precision='twofloat'`` the forward windows run in
    double-float and the backward pass in native float64.  With a ``mesh``
    the ensemble is split over it (:func:`_sharded`), each member keeping
    the noise it draws unsplit."""
    y = _start(f, ic, precision, tensors, tableau, device)
    n_all = y.shape[0]
    return _squeezed(_sharded(mesh, y, f, fjac, lambda fk, jk, yk, members: (
        _ginelli(fk, jk, t0, ta, tb, tc, dt, mdt, yk, n_vec, write_steps,
                 tableau, seed, noise_pert, precision, tensors, members,
                 n_all))))


def _ginelli(f, fjac, t0, ta, tb, tc, dt, mdt, y, n_vec, write_steps,
             tableau, seed, noise_pert, precision, tensors, members, n_all):
    """:func:`compute_clvs_ginelli` of the state ``y``, members ``members``
    of an ensemble of ``n_all``, unsqueezed."""
    df_mode = precision == "twofloat"
    B, n = y.shape
    n_vec = n if n_vec is None else n_vec
    n_pre = _n_windows(t0, ta, dt)
    n_rec = _n_windows(ta, tb, dt)
    n_post = _n_windows(tb, tc, dt)

    rng = np.random.default_rng(seed)
    Q0 = _broadcast(np.linalg.qr(rng.standard_normal((n, n_vec)))[0], y, B)
    A0 = np.linalg.qr(rng.standard_normal((n_vec, n_vec)))[1]
    A = _broadcast(A0 / np.linalg.norm(A0, axis=0, keepdims=True), y, B)
    noise = torch.as_tensor(
        rng.standard_normal((n_rec + n_post, n_all, n_vec))[
            :, members.cpu().numpy()]
        * noise_pert, dtype=y.dtype, device=y.device)
    window, _ = _window(f, fjac, dt, mdt, tableau, False, False, False,
                        precision, tensors, y)
    carry = (df_from_f64(y), df_from_f64(Q0)) if df_mode else (y, Q0)

    for tt in t0 + dt * np.arange(n_pre):
        carry, _ = window(carry, tt)
    idx = _record_index(n_rec, write_steps, n_rec)
    keep = set(idx.tolist())
    ys, Qs, Rs = {}, {}, []
    for i in range(n_rec + n_post + 1):
        if i in keep:
            ys[i] = _to_f64(carry[0], df_mode)
            Qs[i] = _to_f64(carry[1], df_mode)
        if i < n_rec + n_post:
            carry, R = window(carry, ta + dt * i)
            Rs.append(R)

    # backward pass: A_i = normalize(R_i^-1 A_(i+1) + diag(noise_i))
    As, exps = {}, {}
    for i in range(n_rec + n_post - 1, -1, -1):
        if i == n_rec - 1:
            As[n_rec] = A
        A = torch.linalg.solve_triangular(Rs[i], A, upper=True)
        A.diagonal(dim1=-2, dim2=-1).add_(noise[i])
        A, norms = _normalize_columns(A)
        if i < n_rec:
            As[i] = A
            exps[i] = -torch.log(torch.abs(norms)) / dt
    exps[n_rec] = exps[n_rec - 1]
    times = ta + dt * np.arange(n_rec + 1)
    return _outputs(times[idx], [ys[i] for i in idx],
                    [Qs[i] @ As[i] for i in idx], [exps[i] for i in idx])


def _subspace_intersect(Bfull, Ffull):
    """Subspace intersection, batched over the mode index j: CLV_j is the
    leading left singular vector of ``M_j = BLV_1..j+1^T FLV_1..n-j``.  The
    truncation mask is separable, ``M_j = diag(r_j) G diag(c_j)`` with G the
    full overlap Gram matrix, so one masked power iteration on ``M_j
    M_j^T`` runs for every j at once: each sweep is two batched matmuls.
    The iteration runs in blocks of ``chunk`` sweeps with one convergence
    check a block, up to the JAX package's caps and tolerances (float32:
    256 sweeps to 1e-4, then 96 to ``100 eps``; float64: 512 to ``100
    eps``), all in IEEE arithmetic.  Near-degenerate principal-angle pairs
    converge slowly and leave the vector mixed within their plane, as for
    every method."""
    n = Bfull.shape[-1]
    G = torch.einsum('btnv,btnw->btvw', Bfull, Ffull)          # (B, T, n, n)
    rows = torch.arange(n, device=G.device)
    r = (rows[:, None] <= rows[None, :]).to(G.dtype)           # (n, J)
    c = (rows[:, None] < (n - rows)[None, :]).to(G.dtype)

    def norm_cols(U):
        nrm = torch.sqrt(torch.sum(U * U, dim=-2, keepdim=True))
        return U / torch.where(nrm == 0, torch.ones_like(nrm), nrm)

    def sweep(U):
        Y = c * torch.einsum('btvw,btvj->btwj', G, r * U)
        return norm_cols(r * torch.einsum('btvw,btwj->btvj', G, Y))

    def phase(U, chunk, max_sweeps, tol):
        def block(U):
            for _ in range(chunk):
                U = sweep(U)
            return U

        U_prev, U, it = U, block(U), chunk
        while it < max_sweeps and float(torch.abs(
                torch.sum(U * U_prev, dim=-2)).min()) < 1.0 - tol:
            U_prev, U, it = U, block(U), it + chunk
        return U

    weights = 1.0 + rows.to(G.dtype) / n
    U = norm_cols((r * weights[:, None]).expand(G.shape))
    eps = torch.finfo(G.dtype).eps
    if G.dtype == torch.float32:
        U = phase(U, 8, 256, 1e-4)
        U = phase(U, 4, 96, 100.0 * eps)
    else:
        U = phase(U, 8, 512, 100.0 * eps)
    # u_j is zero beyond index j, so the full BLV basis gives the truncated
    # contraction exactly
    return torch.einsum('btnv,btvj->btnj', Bfull, U)


def compute_clvs_subspace(f, fjac, t0, ta, tb, tc, dt, mdt, ic,
                          write_steps=1, tableau=None, seed=0,
                          return_blvs=False, return_flvs=False,
                          precision=None, tensors=None, device=None,
                          mesh=None):
    """Covariant Lyapunov vectors by intersecting the BLV and FLV subspaces
    (Eckmann-Ruelle, Kuptsov-Parlitz): CLV_j spans ``span(BLV_1..j) ∩
    span(FLV_1..n-j+1)``.  The BLVs come from [t0, ta] converging and [ta,
    tb] recording, the FLVs from [ta, tb] recording and [tb, tc] converging
    (``precision='twofloat'`` propagates both passes in double-float).  The
    local exponents come from one TGLS ``mdt`` step of ``f``/``fjac`` on the
    CLVs.  Returns ``(times, traj, exponents, vectors)`` and, when asked,
    ``(exponents, vectors)`` of the BLVs and of the FLVs.  With a ``mesh``
    the whole computation runs shard by shard (:func:`_sharded`)."""
    y = _start(f, ic, precision, tensors, tableau, device)
    return _squeezed(_sharded(mesh, y, f, fjac, lambda fk, jk, yk, _: (
        _subspace(fk, jk, t0, ta, tb, tc, dt, mdt, yk, write_steps, tableau,
                  seed, return_blvs, return_flvs, precision, tensors))))


def _subspace(f, fjac, t0, ta, tb, tc, dt, mdt, y, write_steps, tableau,
              seed, return_blvs, return_flvs, precision, tensors):
    """:func:`compute_clvs_subspace` of the state ``y``, unsqueezed."""
    B, n = y.shape
    kw = dict(write_steps=write_steps, adjoint=False, inverse=False,
              tableau=tableau, seed=seed, precision=precision,
              tensors=tensors)
    tt_b, traj, bexp, bvec = _backward(f, fjac, t0, ta, tb, dt, mdt, y, n,
                                       **kw)
    # the forward pass starts at ta, from the state there
    _, _, fexp, fvec = _forward(f, fjac, ta, tb, tc, dt, mdt, traj[:, :, 0],
                                n, **kw)

    Bfull = torch.movedim(bvec, -1, 1)                           # (B, T, n, n)
    Ffull = torch.movedim(fvec, -1, 1)
    clvs = torch.movedim(_subspace_intersect(Bfull, Ffull), 1, -1)

    # local exponents: one TGLS mdt step of every record at once
    T = clvs.shape[-1]
    tgls = make_tgls_step(f, fjac, *(tableau if tableau is not None
                                     else rk4_tableau()))
    ys = torch.movedim(traj, -1, 0).reshape(T * B, n)
    vs = torch.movedim(clvs, -1, 0).reshape(T * B, n, n)
    _, v2 = tgls((ys, vs), 0.0, mdt)
    _, norms = _normalize_columns(v2)
    exps = torch.movedim((torch.log(torch.abs(norms)) / mdt).reshape(T, B, n),
                         0, -1)

    out = [tt_b, traj, exps, clvs]
    if return_blvs:
        out.append((bexp, bvec))
    if return_flvs:
        out.append((fexp, fvec))
    return tuple(out)


# ---------------------------------------------------------------------------
# Estimator classes (reference API surface)
# ---------------------------------------------------------------------------

def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class _Estimator:
    """What the two estimators share: the tableau, the functions, and the
    model's tensors when ``fjac`` is the same model's Jacobian."""

    def __init__(self, b, c, a, number_of_dimensions, precision, device,
                 mesh):
        # partial tableaux merge with the RK4 defaults, as set_bca
        self.tableau = merge_tableau(a, b, c)
        self.func = None
        self.func_jac = None
        self.n_dim = number_of_dimensions
        self.ic = None
        self._result = None
        if precision not in (None, "float64", "twofloat"):
            raise ValueError(
                f"unknown precision {precision!r}: expected None/'float64' "
                "(the functions' dtype) or 'twofloat'")
        self.precision = precision
        self.device = device
        self.mesh = mesh
        self._tensors = None

    def set_func(self, f, fjac):
        """Set the tendency and Jacobian functions.  The model's tensors
        (direct tangent path, twofloat tier) are kept only when ``fjac``
        derives from the same model (value-equal Jacobian tensors), so that
        a custom ``fjac`` stays honored."""
        self.func = getattr(f, "batched", f)
        self.func_jac = getattr(fjac, "batched", fjac)
        qgt = getattr(f, "qgtensor", None)
        if qgt is not None and same_model_jacobian(fjac, qgt):
            self._tensors = (qgt.tensor, qgt.jacobian_tensor)
        else:
            self._tensors = None

    def start(self):
        pass

    def terminate(self):
        pass

    stop = terminate

    def set_bca(self, b=None, c=None, a=None, ic_init=True):
        """Change the Butcher tableau (partial updates keep the other
        coefficients)."""
        self.tableau = merge_tableau(a, b, c, current=self.tableau)
        if ic_init:
            self.ic = None

    def _kw(self):
        return dict(tableau=self.tableau, precision=self.precision,
                    tensors=self._tensors, device=self.device,
                    mesh=self.mesh)

    def _ic(self, ic):
        return self.ic if ic is None else ic


class LyapunovsEstimator(_Estimator):
    """Benettin BLV/FLV estimator with the reference's class API.
    ``precision='twofloat'`` propagates the tangent in double-float and
    needs ``set_func`` with functions from ``create_tendencies``; ``device``
    is the device for functions that carry none (default ``"cuda"``);
    ``mesh`` splits the ensemble of initial conditions, with their tangent
    blocks, over its devices."""

    def __init__(self, num_threads=None, b=None, c=None, a=None,
                 number_of_dimensions=None, precision=None, device=None,
                 mesh=None):
        super().__init__(b, c, a, number_of_dimensions, precision, device,
                         mesh)

    def compute_lyapunovs(self, t0, tw, t, dt, mdt, ic=None, write_steps=1,
                          n_vec=None, forward=False, adjoint=False,
                          inverse=False):
        compute = (compute_forward_lyapunovs if forward
                   else compute_backward_lyapunovs)
        self._result = compute(
            self.func, self.func_jac, t0, tw, t, dt, mdt, self._ic(ic),
            n_vec=n_vec, write_steps=write_steps, adjoint=adjoint,
            inverse=inverse, **self._kw())

    def get_lyapunovs(self):
        """Return ``(times, trajectory, exponents, vectors)`` as NumPy
        arrays."""
        t, traj, exp, vec = self._result
        return t, _numpy(traj), _numpy(exp), _numpy(vec)


class CovariantLyapunovsEstimator(_Estimator):
    """CLV estimator: the Ginelli method (``method=0``) or the subspace
    intersection (``method=1``)."""

    def __init__(self, num_threads=None, b=None, c=None, a=None,
                 number_of_dimensions=None, noise_pert=0.0, precision=None,
                 device=None, mesh=None):
        super().__init__(b, c, a, number_of_dimensions, precision, device,
                         mesh)
        self.noise_pert = noise_pert
        self._blvs = None
        self._flvs = None
        self.method = 0

    def set_noise_pert(self, noise_pert):
        """Set the Ginelli R-diagonal noise-regularization amplitude."""
        self.noise_pert = noise_pert

    def compute_clvs(self, t0, ta, tb, tc, dt, mdt, ic=None, write_steps=1,
                     n_vec=None, method=None, backward_vectors=False,
                     forward_vectors=False):
        if method is None:
            method = self.method
        self.method = method
        ic = self._ic(ic)
        if method == 0:
            self._result = compute_clvs_ginelli(
                self.func, self.func_jac, t0, ta, tb, tc, dt, mdt, ic,
                n_vec=n_vec, write_steps=write_steps,
                noise_pert=self.noise_pert, **self._kw())
            self._blvs = self._flvs = None
            return
        out = compute_clvs_subspace(
            self.func, self.func_jac, t0, ta, tb, tc, dt, mdt, ic,
            write_steps=write_steps, return_blvs=backward_vectors,
            return_flvs=forward_vectors, **self._kw())
        self._result = out[:4]
        rest = list(out[4:])
        self._blvs = rest.pop(0) if backward_vectors else None
        self._flvs = rest.pop(0) if forward_vectors else None

    def get_clvs(self):
        """Return ``(times, trajectory, exponents, vectors)`` as NumPy
        arrays."""
        t, traj, exp, vec = self._result
        return t, _numpy(traj), _numpy(exp), _numpy(vec)

    def _with_vectors(self, pair):
        if pair is None:
            return None
        exp, vec = pair
        return (self._result[0], _numpy(self._result[1]), _numpy(exp),
                _numpy(vec))

    def get_blvs(self):
        return self._with_vectors(self._blvs)

    def get_flvs(self):
        return self._with_vectors(self._flvs)
