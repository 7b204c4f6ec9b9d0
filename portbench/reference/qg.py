"""Plain reference of the port's timed paths.

A straightforward float64 (or, for the control, float32) formulation in
plain PyTorch over the frozen tensor of a configuration
(``reference/tensors/<config>.npz``, made once from the configuration's
parameters by another package's host layers, outside the benchmark;
PERF.md gives the calls and each file's sha256): the quadratic tendency
``f_i(x) = sum_jk T_ijk xx_j xx_k`` with ``xx = [1, x]``, its Jacobian,
classical RK4 on qgs's time grid, and the Benettin algorithm of backward
Lyapunov vectors.
It imports nothing of the port and uses none of its layouts or kernels."""

from __future__ import annotations

import json
import pathlib
from typing import NamedTuple

import numpy as np
import torch

TENSORS = pathlib.Path(__file__).resolve().parent / "tensors"


class FrozenTensor(NamedTuple):
    coords: np.ndarray      # (3, nnz) int64
    data: np.ndarray        # (nnz,) float64
    shape: tuple


def load_tensor(config):
    """The frozen tensor of ``config`` (a configuration file's dict); raises
    if it was made from other parameters than the file states now."""
    with np.load(TENSORS / f"{config['name']}.npz", allow_pickle=False) as z:
        made_from = str(z["qgparams"])
        tensor = FrozenTensor(z["coords"], z["data"], tuple(z["shape"]))
    if made_from != json.dumps(config["qgparams"], sort_keys=True):
        raise ValueError(f"reference/tensors/{config['name']}.npz was made "
                         "from other parameters than the configuration file "
                         "holds: make it again (PERF.md gives how)")
    return tensor


class Quadratic:
    """The tendency and Jacobian of a rank-3 COO tensor, in ``dtype`` on
    ``device``, for states (B, n)."""

    def __init__(self, tensor, dtype=torch.float64, device="cpu"):
        c = tensor.coords[:, tensor.coords[0] != 0]
        vals = tensor.data[tensor.coords[0] != 0]
        self.n = int(tensor.shape[0]) - 1
        as_idx = (lambda a: torch.as_tensor(a, dtype=torch.int64,
                                            device=device))
        self.i, self.j, self.k = (as_idx(c[0] - 1), as_idx(c[1]),
                                  as_idx(c[2]))
        self.v = torch.as_tensor(vals, dtype=dtype, device=device)
        self.dtype, self.device = dtype, torch.device(device)
        # the Jacobian's terms: d/dx_l of v xx_j xx_k is v xx_k at l = j
        # and v xx_j at l = k (state index l - 1 when l >= 1)
        dj, dk = c[1] != 0, c[2] != 0
        self.jac_at = as_idx(np.concatenate([
            (c[0] - 1) * self.n + c[1] - 1, (c[0] - 1) * self.n + c[2] - 1])[
                np.concatenate([dj, dk])])
        self.jac_other = as_idx(np.concatenate([c[2], c[1]])[
            np.concatenate([dj, dk])])
        self.jac_v = torch.as_tensor(np.concatenate([vals, vals])[
            np.concatenate([dj, dk])], dtype=dtype, device=device)

    def _xx(self, x):
        return torch.cat([torch.ones_like(x[:, :1]), x], dim=1)

    def __call__(self, x):
        xx = self._xx(x)
        prod = self.v * xx[:, self.j] * xx[:, self.k]
        return torch.zeros_like(x).index_add_(1, self.i, prod)

    def jacobian(self, x):
        """(B, n, n): ``J[b, i, l] = d f_i / d x_l`` at ``x[b]``."""
        xx = self._xx(x)
        terms = self.jac_v * xx[:, self.jac_other]
        J = x.new_zeros((x.shape[0], self.n * self.n))
        return J.index_add_(1, self.jac_at, terms).view(-1, self.n, self.n)


def time_grid(t0, t1, dt):
    """qgs's integration grid: ``arange(t0, t1, dt)`` and ``t1``."""
    return np.concatenate((np.arange(t0, t1, dt), [t1]))


def record_index(n_points, write_steps):
    """The recorded points of an ``n_points`` grid: every
    ``write_steps``-th and the last."""
    idx = list(range(0, n_points, write_steps))
    if idx[-1] != n_points - 1:
        idx.append(n_points - 1)
    return idx


def rk4(f, y, h):
    k1 = f(y)
    k2 = f(y + 0.5 * h * k1)
    k3 = f(y + 0.5 * h * k2)
    k4 = f(y + h * k3)
    return y + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def integrate(tendency, ic, t0, t1, dt, write_steps, block=None):
    """Classical RK4 of ``ic`` (B, n) over qgs's grid from ``t0`` to
    ``t1``, recording every ``write_steps``-th state and the last: (B, n,
    n_records) in the tendency's dtype on its device, computed ``block``
    members at a time (all at once when None)."""
    dts = np.diff(time_grid(t0, t1, dt))
    keep = set(record_index(len(dts) + 1, write_steps))
    ic = torch.as_tensor(ic).to(tendency.device, tendency.dtype)
    block = block or ic.shape[0]
    out = []
    for start in range(0, ic.shape[0], block):
        y = ic[start:start + block]
        recs = [y] if 0 in keep else []
        for s, h in enumerate(dts, 1):
            y = rk4(tendency, y, float(h))
            if s in keep:
                recs.append(y)
        out.append(torch.stack(recs, dim=-1))
    return torch.cat(out)


def benettin_q0(n, n_vec, seed=0):
    """The initial tangent block of qgs's Benettin estimator: the Q of a
    uniform random n x n_vec matrix from ``default_rng(seed)``."""
    return np.linalg.qr(np.random.default_rng(seed).random((n, n_vec)))[0]


def backward_lyapunov(tendency, ic, t0, tw, t, dt, mdt, write_steps,
                      n_vec=None, seed=0):
    """Benettin's algorithm: windows of ``dt``, each ``dt / mdt`` RK4
    steps of size ``mdt`` of the trajectory and its tangent block followed
    by the QR of the block, from ``t0`` to ``tw`` (the transient) and from
    ``tw`` to ``t`` (recorded).  Returns ``(traj (B, n, T), exponents (B, n_vec, T),
    vectors (B, n, n_vec, T))`` at every ``write_steps``-th window start and
    the last; the exponents at a point are ``log|diag R| / dt`` of the
    window before it (zero at ``tw``)."""
    n = tendency.n
    n_vec = n if n_vec is None else n_vec
    y = torch.as_tensor(ic).to(tendency.device, tendency.dtype)
    B = y.shape[0]
    Q = torch.as_tensor(benettin_q0(n, n_vec, seed)).to(y).expand(
        B, n, n_vec)

    n_sub = int(round(dt / mdt))

    def rhs(y, M):
        return tendency(y), tendency.jacobian(y) @ M

    def window(y, M):
        h = mdt
        for _ in range(n_sub):
            k1 = rhs(y, M)
            k2 = rhs(y + 0.5 * h * k1[0], M + 0.5 * h * k1[1])
            k3 = rhs(y + 0.5 * h * k2[0], M + 0.5 * h * k2[1])
            k4 = rhs(y + h * k3[0], M + h * k3[1])
            y = y + h / 6 * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
            M = M + h / 6 * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
        Q, R = torch.linalg.qr(M)
        return y, Q, torch.log(torch.diagonal(R, dim1=-2, dim2=-1).abs()) / dt

    for _ in range(int(round((tw - t0) / dt))):
        y, Q, _ = window(y, Q)
    n_rec = int(round((t - tw) / dt))
    keep = set(record_index(n_rec + 1, write_steps))
    exps = y.new_zeros((B, n_vec))
    ys, ex, vecs = [], [], []
    for i in range(n_rec + 1):
        if i in keep:
            ys.append(y), ex.append(exps), vecs.append(Q)
        if i < n_rec:
            y, Q, exps = window(y, Q)
    stack = (lambda xs: torch.stack(xs, dim=-1))
    return stack(ys), stack(ex), stack(vecs)


def by_members(run, ics):
    """``run`` of the ensembles ``ics`` (a list of (B_i, n) arrays) stacked
    along the members into one, its output (a tensor, or a tuple of them,
    members first) split back: one output an ensemble."""
    sizes = [len(ic) for ic in ics]
    out = run(np.concatenate(ics))
    if isinstance(out, tuple):
        return list(zip(*(torch.split(o, sizes) for o in out)))
    return list(torch.split(out, sizes))
