"""Plain reference of the rank-5 (quartic) tendency.

qgs's full quartic T4 radiation scheme (``docs/model/dynamic_T_T4.md``
§2) expands the Stefan-Boltzmann terms without linearization, so every
output sums products of four state components over the frozen rank-5 COO
tensor of the configuration (``reference/tensors/<config>.npz``)::

    f_i(x) = sum_e v_e xx_j xx_k xx_l xx_m,   (i, j, k, l, m) = coords[:, e]

with ``xx = [1, x]``: an entry whose trailing indices hold 0s is a cubic,
quadratic, linear or constant term.  The products are gathered entry by
entry and summed into their rows by ``index_add_``.  There is no matrix
product anywhere, so no tensor-core (TF32) arithmetic can apply: the sum
is computed in ``dtype`` throughout.

Plain PyTorch; it imports nothing of the port and uses none of its
layouts.  :class:`Quartic` has the interface of :class:`qg.Quadratic`'s
tendency (``n``, ``dtype``, ``device``, ``__call__``), so that
:func:`qg.integrate` and :func:`qg.by_members` drive it."""

from __future__ import annotations

import numpy as np
import torch


class Quartic:
    """The tendency of a rank-5 COO tensor, in ``dtype`` on ``device``,
    for states (B, n)."""

    def __init__(self, tensor, dtype=torch.float64, device="cpu"):
        coords = np.asarray(tensor.coords)
        if coords.shape[0] != 5:
            raise ValueError(f"a rank-5 tensor is needed, not rank "
                             f"{coords.shape[0]}")
        keep = coords[0] != 0            # output row 0 is the dummy
        c = coords[:, keep]
        self.n = int(tensor.shape[0]) - 1
        as_idx = (lambda a: torch.as_tensor(a, dtype=torch.int64,
                                            device=device))
        self.i = as_idx(c[0] - 1)
        self.j, self.k, self.l, self.m = (as_idx(a) for a in c[1:])
        self.v = torch.as_tensor(np.asarray(tensor.data)[keep], dtype=dtype,
                                 device=device)
        self.dtype, self.device = dtype, torch.device(device)

    def __call__(self, x):
        xx = torch.cat([torch.ones_like(x[:, :1]), x], dim=1)
        prod = (self.v * xx[:, self.j] * xx[:, self.k] * xx[:, self.l]
                * xx[:, self.m])
        return torch.zeros_like(x).index_add_(1, self.i, prod)
