"""
Double-float arithmetic, contraction and RK steps
=================================================

Counterpart of :mod:`qgs_tpu.ops.twofloat` for the ``precision='twofloat'``
trajectory integration.  A value is an unevaluated sum ``hi + lo`` of two
float32 tensors, carried as a ``(hi, lo)`` pair; the error-free
transformations (Knuth two-sum, Dekker product with a bitmask split) give
about 48 bits of mantissa.

* The EFTs and double-float ops follow the JAX package's formulas and
  operation order.  Eager PyTorch rounds every operation on its own and
  contracts nothing into an FMA, so the JAX package's optimization barriers
  (and ``no_barriers``) have no counterpart here.
* :class:`DfTendency` is the double-float tendency contraction over the
  layout of :mod:`qgs_tpu_torch.ops.contraction` (row-padded for rank 3,
  two-level for rank 5); every op is renormalized (the JAX package's
  ``accumulate='strict'``).  Given NumPy pairs, it and :class:`DfTangent`
  convert them once to float32 on their device and return NumPy pairs
  (:func:`~qgs_tpu_torch.ops.contraction.numpy_call`).
* :func:`make_df_rk4_step_dynamic` and :func:`make_df_rk_step_dynamic` are
  the double-float RK steps ``step(y, tt, dt) -> y_new`` over a function
  ``f(y_hi, y_lo) -> (f_hi, f_lo)``.  The fused kernel ``csrc/rk4_df_fused.cu``
  computes the RK4 one (:mod:`qgs_tpu_torch.ops.fused_df_rk4`).
  :func:`make_df_rk4_step` is the RK4 step with ``dt`` baked in.
* :class:`DfTangent` is the double-float tangent contraction on the layout
  of :class:`~qgs_tpu_torch.ops.contraction.Tangent` (for rank 5, the
  double-float coefficient, then the product with the tangent block), and
  :func:`make_df_tgls_rk4_step_dynamic`, :func:`make_df_tgls_rk4_step` and
  :func:`make_df_tgls_rk_step_dynamic` are the coupled (trajectory,
  tangent) steps.  The baked RK4 forms split ``dt / 2`` and ``dt / 6`` on
  the host, which are not the bits of the dynamic form's exact half and
  ``df_div_scalar(dt, 6)``.

The JAX package's pair factoring of the quartic entries (``factor_pairs``)
is not ported: a rank-5 slot is the chain of ``df_mul`` over its trailing
gathers.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from qgs_tpu_torch.ops.contraction import (is_tensor_state, jacobian_layout,
                                           numpy_call, padded_layout,
                                           tangent_layout, with_zero)


# ---------------------------------------------------------------------------
# error-free transformations (float32 in, float32 out)
# ---------------------------------------------------------------------------

def two_sum(a, b):
    """Knuth two-sum: ``s + err == a + b`` exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Fast two-sum, for ``|a| >= |b|``."""
    s = a + b
    return s, b - (s - a)


def split(a):
    """Split a float32 into two halves of at most 12 mantissa bits, ``hi +
    lo == a`` exactly, by masking the low 12 mantissa bits (``0xFFFFF000``,
    which is -4096 as int32)."""
    hi = (a.view(torch.int32) & -4096).view(torch.float32)
    return hi, a - hi


def two_prod(a, b):
    """Dekker product: ``p + err == a * b`` exactly."""
    p = a * b
    ahi, alo = split(a)
    bhi, blo = split(b)
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


# ---------------------------------------------------------------------------
# double-float ops on (hi, lo) pairs
# ---------------------------------------------------------------------------

def df_add(x, y):
    s, e = two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    return quick_two_sum(s, e)


def df_mul(x, y):
    p, e = two_prod(x[0], y[0])
    e = e + x[0] * y[1] + x[1] * y[0]
    return quick_two_sum(p, e)


def df_scale(x, c):
    """Multiply by a float32 scalar ``c`` that is exactly representable."""
    c = torch.full_like(x[0], c)
    p, e = two_prod(x[0], c)
    e = e + x[1] * c
    return quick_two_sum(p, e)


def df_from_f64(a):
    """float64 tensor -> (hi, lo) float32 pair."""
    hi = a.float()
    return hi, (a - hi.double()).float()


def df_to_f64(x):
    return x[0].double() + x[1].double()


def df_const(value, device="cuda"):
    """Python float -> scalar (hi, lo) pair of 0-d float32 tensors."""
    hi = np.float32(value)
    lo = np.float32(value - np.float64(hi))
    return (torch.tensor(hi, device=device), torch.tensor(lo, device=device))


def df_div_scalar(x, c):
    """Divide a pair by an exactly representable float32 scalar: one
    rounded quotient, corrected by the exact remainder."""
    c = torch.full_like(x[0], c)        # a true division, not a reciprocal
    q = x[0] / c
    p, e = two_prod(q, c)
    r = ((x[0] - p) - e + x[1]) / c
    return quick_two_sum(q, r)


def df_reduce_last(x):
    """Pairwise double-float sum over the last axis (any width): the first
    half is added to the second, and an odd width carries its last lane to
    a final combine, as the JAX package's ``df_reduce_last``."""
    hi, lo = x
    width = hi.shape[-1]
    carries = []
    while width > 1:
        half = width // 2
        if width % 2:
            carries.append((hi[..., -1], lo[..., -1]))
        hi, lo = df_add((hi[..., :half], lo[..., :half]),
                        (hi[..., half:2 * half], lo[..., half:2 * half]))
        width = half
    out = (hi[..., 0], lo[..., 0])
    for c in carries:
        out = df_add(out, c)
    return out


# ---------------------------------------------------------------------------
# double-float tendency contraction
# ---------------------------------------------------------------------------

def split_values(vals):
    """float64 tensor values -> their (hi, lo) float32 split, on the host."""
    vals = np.asarray(vals, np.float64)
    vhi = vals.astype(np.float32)
    return vhi, (vals - vhi.astype(np.float64)).astype(np.float32)


class _DfContraction(nn.Module):
    """Double-float ``prod_a xx[idx_a] * v`` summed over the slot axis by
    :func:`df_reduce_last`, and for a two-level layout the chunk sums of
    each row summed the same way and placed at the outputs: a (B, n1) pair
    -> a (B, *out_shape) pair."""

    def __init__(self, layout, out_shape, device):
        super().__init__()
        vals, idxs, chunks, perm = layout
        vhi, vlo = split_values(vals)
        bufs = {"vhi": vhi, "vlo": vlo}
        bufs.update((f"idx{k}", idx) for k, idx in enumerate(idxs))
        for name, a in bufs.items():
            self.register_buffer(name, torch.as_tensor(a, device=device))
        self.n_idx = len(idxs)
        self.two_level = chunks is not None
        if self.two_level:
            self.register_buffer("chunks", torch.as_tensor(chunks,
                                                           device=device))
            self.register_buffer("perm", torch.as_tensor(perm, device=device))
        self.out_shape = tuple(out_shape)

    @property
    def device(self):
        return self.vhi.device

    def contract(self, xx):
        t = (self.vhi, self.vlo)
        for a in range(self.n_idx):
            idx = getattr(self, f"idx{a}")
            t = df_mul(t, (xx[0][:, idx], xx[1][:, idx]))       # (B, ..., R)
        out = df_reduce_last(t)
        if self.two_level:
            out = df_reduce_last(tuple(with_zero(p)[:, self.chunks]
                                       for p in out))
            out = tuple(with_zero(p)[:, self.perm] for p in out)
        B = xx[0].shape[0]
        return tuple(p.reshape((B,) + self.out_shape) for p in out)


class DfTendency(_DfContraction):
    """Double-float tendency ``f(y_hi, y_lo) -> (f_hi, f_lo)``: (B, n)
    pairs in and out, ``f_i = sum_e v_e prod_{a>=1} xx[coords[a, e]]`` over
    ``xx = [1, y]`` (the dummy's lo is 0), of a tensor of rank 3 or 5 given
    as COO arrays ``coords`` (rank, nnz), ``data`` (nnz,) and ``shape``
    (n1,) * rank, such as the JAX package's ``QgsTensor.tensor``.

    On the layout of :func:`~qgs_tpu_torch.ops.contraction.padded_layout`
    every slot is ``(((v * xx[j]) * xx[k]) ...)`` in double-float (a gather
    at index 0 is the exact (1, 0), which ``df_mul`` leaves unchanged), and
    the slots are summed by :func:`df_reduce_last`.  The host arrays stay
    on the module (``coords``, ``data``, ``shape``) for the fused kernel
    (rank 3) to build its own layout from."""

    def __init__(self, coords, data, shape, device="cuda"):
        coords = np.asarray(coords, np.int64)
        data = np.asarray(data, np.float64)
        n = int(shape[0]) - 1
        keep = coords[0] != 0            # output row 0 is the dummy: dropped
        layout = padded_layout(coords[0][keep] - 1, n,
                               [c[keep] for c in coords[1:]], data[keep],
                               len(shape))
        super().__init__(layout, (n,), device)
        self.coords, self.data = coords, data
        self.shape = tuple(int(s) for s in shape)

    def forward(self, y_hi, y_lo):
        if not is_tensor_state(y_hi, y_lo):
            return numpy_call(self.forward, (y_hi, y_lo), torch.float32,
                              self.device)
        return self.contract(pad_dummy((y_hi, y_lo)))


class DfTangent(nn.Module):
    """Double-float tangent contraction ``hom(xx, dm) -> df (B, n, n_tg)``
    over the dummy-padded state pair ``xx`` (B, n1) and the tangent block
    pair ``dm`` (B, n, n_tg), of a Jacobian tensor of rank 3 or 5 given as
    COO arrays: the counterpart of the JAX package's
    ``make_df_tangent_contraction``, on the layout of
    :class:`~qgs_tpu_torch.ops.contraction.Tangent`.  Rank 3: each slot is
    ``df_mul(df_mul(v, xx[k]), dm[m])`` and the slots of an output row are
    summed by :func:`df_reduce_last`.  Rank 5: the double-float coefficient
    ``C[b, i, m]`` (``.coef``, the transformed Jacobian on its two-level
    layout), then ``df_mul(C[b, i, m], dm[b, m, t])`` summed over ``m`` by
    :func:`df_reduce_last`.

    The module keeps the untransformed host arrays and its ``adjoint`` and
    ``inverse`` flags; :meth:`with_transform` composes a further
    transform."""

    def __init__(self, coords, data, shape, adjoint=False, inverse=False,
                 device="cuda"):
        super().__init__()
        self.coords, self.data = coords, data
        self.shape = tuple(int(s) for s in shape)
        self.adjoint, self.inverse = adjoint, inverse
        self.coef = None
        if len(shape) != 3:
            n = self.shape[0] - 1
            self.coef = _DfContraction(
                jacobian_layout(coords, data, shape, adjoint, inverse),
                (n, n), device)
            return
        vals, idx_m, idx_k = tangent_layout(coords, data, shape, adjoint,
                                            inverse)
        vhi, vlo = split_values(vals)
        for name, a in (("vhi", vhi), ("vlo", vlo), ("idx_m", idx_m),
                        ("idx_k", idx_k)):
            self.register_buffer(name, torch.as_tensor(a, device=device))

    @property
    def device(self):
        return (self.vhi if self.coef is None else self.coef.vhi).device

    def with_transform(self, adjoint=False, inverse=False):
        """This contraction, further transposed for ``adjoint`` and negated
        for ``inverse`` (itself when neither is asked)."""
        if not (adjoint or inverse):
            return self
        return DfTangent(self.coords, self.data, self.shape,
                         self.adjoint != adjoint, self.inverse != inverse,
                         self.device)

    def forward(self, xx, dm):
        if not is_tensor_state(xx, dm):
            return numpy_call(self.forward, (xx, dm), torch.float32,
                              self.device)
        if self.coef is not None:
            c = self.coef.contract(xx)                          # (B, n, n)
            t = df_mul(tuple(p[..., None] for p in c),
                       tuple(p[:, None] for p in dm))           # (B, n, n, t)
            return df_reduce_last(tuple(p.transpose(-1, -2) for p in t))
        xk = (xx[0][:, self.idx_k], xx[1][:, self.idx_k])      # (B, n, R)
        coef = df_mul((self.vhi, self.vlo), xk)
        dmg = (dm[0][:, self.idx_m], dm[1][:, self.idx_m])     # (B, n, R, t)
        t = df_mul((coef[0][..., None], coef[1][..., None]), dmg)
        return df_reduce_last((t[0].transpose(-1, -2),
                               t[1].transpose(-1, -2)))


def make_df_tangent_contraction(jtensor, adjoint=False, inverse=False,
                                device="cuda"):
    """:class:`DfTangent` of a COO Jacobian tensor
    (``QgsTensor.jacobian_tensor``)."""
    return DfTangent(jtensor.coords, jtensor.data, jtensor.shape, adjoint,
                     inverse, device)


def pad_dummy(y):
    """Prepend the exact dummy 1 (lo 0) to a (B, n) state pair."""
    one = torch.ones_like(y[0][:, :1])
    return (torch.cat([one, y[0]], dim=1),
            torch.cat([torch.zeros_like(one), y[1]], dim=1))


# ---------------------------------------------------------------------------
# double-float Runge-Kutta steps
# ---------------------------------------------------------------------------

def _axpy(y, c, k):
    """``y + c * k`` in double-float, ``c`` a scalar pair."""
    return df_add(y, df_mul(k, c))


def _check_explicit_tableau(a, b, c):
    """Validate an explicit Butcher tableau (strictly lower-triangular
    ``a``) for the double-float steps; returns float64 arrays."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = len(b)
    if a.shape != (s, s) or c.shape != (s,):
        raise ValueError(
            f"inconsistent Butcher tableau shapes: a {a.shape}, b ({s},), "
            f"c {c.shape}")
    if np.any(np.triu(a) != 0.0):
        raise ValueError(
            "precision='twofloat' supports explicit Runge-Kutta tableaux "
            "only (a must be strictly lower triangular)")
    return a, b, c


def make_df_rk4_step_dynamic(f):
    """Classical RK4 step ``step(y, tt, dt) -> y_new`` in double-float over
    ``f(y_hi, y_lo) -> (f_hi, f_lo)``, ``y`` a (B, n) pair, ``dt`` a float64
    scalar split into a pair by :func:`df_const`.  ``half_dt`` is the exact ``0.5 *
    (hi, lo)``, ``sixth_dt`` is ``df_div_scalar(dt, 6)``, and the combine is
    ``y + sixth_dt * ((k1 + k4) + 2 (k2 + k3))``, as the JAX package's
    ``_df_rk4_core``.  The model is autonomous: ``tt`` is unused."""
    def step(y, tt, dt):
        del tt
        return _rk4(f, y, *_dynamic_dts(dt, y[0].device))

    return step


def make_df_rk4_step(f, dt, device="cuda"):
    """Classical RK4 step ``step(y) -> y_new`` with ``dt`` baked in: ``dt``,
    ``dt / 2`` and ``dt / 6`` each split into a pair on the host (the JAX
    package's ``make_df_rk4_step``)."""
    dts = _baked_dts(dt, device)

    def step(y):
        return _rk4(f, y, *dts)

    return step


def _dynamic_dts(dt, device):
    """``(dt, dt / 2, dt / 6)`` as the dynamic RK4 steps form them: ``dt``
    split by :func:`df_const`, its exact half and ``df_div_scalar(dt,
    6)``."""
    dt_df = df_const(float(dt), device)
    return dt_df, (0.5 * dt_df[0], 0.5 * dt_df[1]), df_div_scalar(dt_df, 6.0)


def _baked_dts(dt, device):
    """``(dt, dt / 2, dt / 6)`` as the baked RK4 steps form them: each
    quotient taken in float64 and split by :func:`df_const`."""
    return (df_const(dt, device), df_const(dt / 2.0, device),
            df_const(dt / 6.0, device))


def _rk4(f, y, dt_df, half_dt, sixth_dt):
    """The RK4 stages and the combine ``y + sixth_dt * ((k1 + k4) + 2 (k2 +
    k3))``, as the JAX package's ``_df_rk4_core``."""
    k1 = f(*y)
    k2 = f(*_axpy(y, half_dt, k1))
    k3 = f(*_axpy(y, half_dt, k2))
    k4 = f(*_axpy(y, dt_df, k3))
    ksum = df_add(df_add(k1, k4), df_scale(df_add(k2, k3), 2.0))
    return _axpy(y, sixth_dt, ksum)


def _tableau_consts(a, b, device):
    """Each nonzero coefficient of an explicit tableau split into a pair on
    the host: ``(a_consts, b_consts)``, ``None`` for a zero."""
    s = len(b)
    a_consts = [[df_const(a[i, l], device) if a[i, l] != 0.0 else None
                 for l in range(s)] for i in range(s)]
    return a_consts, [df_const(v, device) if v != 0.0 else None for v in b]


def make_df_rk_step_dynamic(f, a, b, c):
    """Double-float RK step ``step(y, tt, dt) -> y_new`` for any explicit
    Butcher tableau: each coefficient is split into an exact pair on the
    host and ``dt * coeff`` is a scalar double-float product."""
    a, b, c = _check_explicit_tableau(a, b, c)
    s = len(b)

    def step(y, tt, dt):
        del tt                       # every qgs tendency is autonomous
        device = y[0].device
        dt_df = df_const(float(dt), device)
        a_consts, b_consts = _tableau_consts(a, b, device)
        k = []
        for i in range(s):
            y_s = y
            for l in range(i):
                if a_consts[i][l] is not None:
                    y_s = _axpy(y_s, df_mul(dt_df, a_consts[i][l]), k[l])
            k.append(f(*y_s))
        y_new = y
        for i in range(s):
            if b_consts[i] is not None:
                y_new = _axpy(y_new, df_mul(dt_df, b_consts[i]), k[i])
        return y_new

    return step


# ---------------------------------------------------------------------------
# double-float tangent-linear (TGLS) steps
# ---------------------------------------------------------------------------

def _tgls_rhs(f, tangent):
    """``rhs(y, dm) -> (f(y), tangent([1, y], dm))`` of the coupled system."""
    def rhs(y, dm):
        return f(*y), tangent(pad_dummy(y), dm)

    return rhs


def _tgls_rk4(rhs, carry, dt_df, half_dt, sixth_dt):
    """One RK4 step of the coupled system, as the JAX package's
    ``_df_tgls_rk4_core``."""
    y, dm = carry
    k1, m1 = rhs(y, dm)
    k2, m2 = rhs(_axpy(y, half_dt, k1), _axpy(dm, half_dt, m1))
    k3, m3 = rhs(_axpy(y, half_dt, k2), _axpy(dm, half_dt, m2))
    k4, m4 = rhs(_axpy(y, dt_df, k3), _axpy(dm, dt_df, m3))
    ks = df_add(df_add(k1, k4), df_scale(df_add(k2, k3), 2.0))
    ms = df_add(df_add(m1, m4), df_scale(df_add(m2, m3), 2.0))
    return _axpy(y, sixth_dt, ks), _axpy(dm, sixth_dt, ms)


def make_df_tgls_rk4_step_dynamic(f, tangent):
    """Classical RK4 step ``step((y, dm), tt, dt) -> (y', dm')`` of the
    coupled (trajectory, tangent) system in double-float: ``f(y_hi, y_lo)``
    the tendency (a :class:`DfTendency`), ``tangent(xx, dm)`` the tangent
    contraction (a :class:`DfTangent`, carrying any adjoint or inverse
    transform); ``dt`` split as :func:`make_df_rk4_step_dynamic` splits it."""
    rhs = _tgls_rhs(f, tangent)

    def step(carry, tt, dt):
        del tt
        return _tgls_rk4(rhs, carry, *_dynamic_dts(dt, carry[0][0].device))

    return step


def make_df_tgls_rk4_step(f, tangent, dt, device="cuda"):
    """The coupled RK4 step ``step((y, dm)) -> (y', dm')`` with ``dt``
    baked in as :func:`make_df_rk4_step` bakes it."""
    rhs = _tgls_rhs(f, tangent)
    dts = _baked_dts(dt, device)

    def step(carry):
        return _tgls_rk4(rhs, carry, *dts)

    return step


def make_df_tgls_rk_step_dynamic(f, tangent, a, b, c):
    """The coupled double-float step ``step((y, dm), tt, dt) -> (y', dm')``
    for any explicit Butcher tableau, each ``dt * coeff`` a scalar
    double-float product (as :func:`make_df_rk_step_dynamic`)."""
    a, b, c = _check_explicit_tableau(a, b, c)
    s = len(b)
    rhs = _tgls_rhs(f, tangent)

    def step(carry, tt, dt):
        del tt
        (y, dm), device = carry, carry[0][0].device
        dt_df = df_const(float(dt), device)
        a_consts, b_consts = _tableau_consts(a, b, device)
        k, km = [], []
        for i in range(s):
            y_s, dm_s = y, dm
            for l in range(i):
                if a_consts[i][l] is not None:
                    cdf = df_mul(dt_df, a_consts[i][l])
                    y_s = _axpy(y_s, cdf, k[l])
                    dm_s = _axpy(dm_s, cdf, km[l])
            ki, mi = rhs(y_s, dm_s)
            k.append(ki)
            km.append(mi)
        y_new, dm_new = y, dm
        for i in range(s):
            if b_consts[i] is not None:
                cdf = df_mul(dt_df, b_consts[i])
                y_new = _axpy(y_new, cdf, k[i])
                dm_new = _axpy(dm_new, cdf, km[i])
        return y_new, dm_new

    return step
