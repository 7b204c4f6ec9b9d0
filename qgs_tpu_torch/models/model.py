"""
High-level model object and checkpointing
=========================================

Counterpart of :mod:`qgs_tpu.models.model`: :class:`QgsModel` ties the
configuration, its tendency tensor and the PyTorch tendency modules
together, and pickles the configuration and the tensor (not the modules),
so that a restored model skips the inner products and the tensor assembly.
A file the port wrote holds the port's own host classes; one the JAX
package wrote holds ``qgs_tpu`` classes and is not read here.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from qgs_tpu_torch.models.tendencies import _build_inner_products, build_tensor
from qgs_tpu_torch.ops.contraction import make_tendency_fns, single_state


class QgsModel:
    """A configured model: parameters, tendency tensor and tendency modules.

    Parameters
    ----------
    params: QgParams
        Fully specified model configuration (the port's own class).
    mode: str
        Contraction mode: any of the JAX package's names, all one path.
    dtype: torch.dtype
        The modules' dtype (default float64).
    device: str or torch.device
        The modules' device (default ``"cuda"``; ``"cpu"`` for the CPU).

    ``f`` and ``Df`` act on single states, their batched versions are
    ``.batched`` (also ``f_batched`` and ``Df_batched``), and both carry
    the tensor object as ``.qgtensor``, as :func:`create_tendencies`'s do.
    """

    def __init__(self, params, mode="auto", dtype=torch.float64,
                 device="cuda", _tensor=None):
        self.params = params
        if _tensor is None:
            aip, oip, gip = _build_inner_products(params)
            self.inner_products = (aip, oip, gip)
            self.tensor = build_tensor(params, aip, oip, gip)
        else:
            self.inner_products = None
            self.tensor = _tensor
        self.f_batched, self.Df_batched = make_tendency_fns(
            self.tensor.tensor, self.tensor.jacobian_tensor, mode=mode,
            dtype=dtype, device=device)
        self.f = single_state(self.f_batched)
        self.Df = single_state(self.Df_batched)
        self.f.qgtensor = self.Df.qgtensor = self.tensor

    @property
    def ndim(self):
        return self.params.ndim

    def save(self, filename):
        """Pickle the configuration and the tensor object."""
        with open(filename, "wb") as fh:
            pickle.dump({"params": self.params, "tensor": self.tensor}, fh)

    @classmethod
    def load(cls, filename, mode="auto", dtype=torch.float64, device="cuda"):
        """Restore a model from :meth:`save`'s file, without recomputing
        the inner products and the tensor."""
        with open(filename, "rb") as fh:
            state = pickle.load(fh)
        return cls(state["params"], mode=mode, dtype=dtype, device=device,
                   _tensor=state["tensor"])


def _host(a):
    """A tensor (on any device) or array-like as a NumPy array."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def save_trajectory_checkpoint(filename, t, state, **extra):
    """Checkpoint an integration: time and state (tensors or arrays) and
    any extra arrays, in a NumPy ``.npz`` file.  Restart by feeding
    ``state`` back as the initial condition."""
    np.savez(filename, t=_host(t), state=_host(state),
             **{k: _host(v) for k, v in extra.items()})


def load_trajectory_checkpoint(filename):
    """``(t, state, extra)`` from :func:`save_trajectory_checkpoint`'s
    file, as NumPy arrays."""
    data = np.load(filename, allow_pickle=False)
    return data["t"], data["state"], {k: data[k] for k in data.files
                                      if k not in ("t", "state")}
