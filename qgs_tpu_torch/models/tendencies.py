"""
Tendencies factory
==================

Counterpart of :mod:`qgs_tpu.models.tendencies`: ``create_tendencies``
builds the inner products and the tendency tensor on the host (the port's
NumPy/SymPy layers, :mod:`qgs_tpu_torch.host`) and returns the PyTorch tendency ``f(t, x)``
and Jacobian ``Df(t, x)`` on single states, with their batched versions
attached as ``.batched`` and the tensor object as ``.qgtensor``.
"""

from __future__ import annotations

import torch

from qgs_tpu_torch.host import (
    AtmosphericAnalyticInnerProducts, AtmosphericSymbolicInnerProducts,
    GroundAnalyticInnerProducts, GroundSymbolicInnerProducts,
    OceanicAnalyticInnerProducts, OceanicSymbolicInnerProducts, QgsTensor,
)
from qgs_tpu_torch.ops.contraction import make_tendency_fns, single_state


def _check_supported(params):
    if params.T4 or params.dynamic_T:
        raise NotImplementedError(
            "T4 and dynamic-T configurations (rank-5 tensors) are not ported "
            "yet: ROADMAP queue 1, item 8")


def _build_inner_products(params):
    """Pick analytic or symbolic inner products from the configuration
    (same choice as ``qgs_tpu.models.tendencies._build_inner_products``)."""
    _check_supported(params)
    aip = oip = gip = None
    if params.ablocks is not None:
        aip = AtmosphericAnalyticInnerProducts(params)
    elif params.atmospheric_basis is not None:
        aip = AtmosphericSymbolicInnerProducts(params)

    if params.oblocks is not None:
        oip = OceanicAnalyticInnerProducts(params)
    elif params.oceanic_basis is not None:
        oip = OceanicSymbolicInnerProducts(params)

    if params.gblocks is not None:
        gip = GroundAnalyticInnerProducts(params)
    elif params.ground_basis is not None:
        gip = GroundSymbolicInnerProducts(params)

    if aip is not None and oip is not None:
        if not aip.connected_to_ocean:
            aip.connect_to_ocean(oip)
    elif aip is not None and gip is not None:
        if not aip.connected_to_ground:
            aip.connect_to_ground(gip)
    return aip, oip, gip


def build_tensor(params, aip, oip, gip):
    _check_supported(params)
    return QgsTensor(params, aip, oip, gip)


def create_tendencies(params, return_inner_products=False,
                      return_qgtensor=False, mode="auto",
                      dtype=torch.float64, device="cuda"):
    """Build the tendencies ``f(t, x)`` and Jacobian ``Df(t, x)``.

    Both returned modules operate on single states (shape (ndim,)) like the
    reference; batched versions over a leading ensemble axis are attached as
    ``f.batched`` / ``Df.batched``.  Their buffers live on ``device`` (the
    CUDA card unless another device is asked for, ``device="cpu"`` for the
    CPU; without a card the default raises) in ``dtype``; an integrator
    given ``f`` integrates there, in that dtype.
    """
    aip, oip, gip = _build_inner_products(params)
    agotensor = build_tensor(params, aip, oip, gip)

    f_batched, Df_batched = make_tendency_fns(
        agotensor.tensor, agotensor.jacobian_tensor, mode=mode, dtype=dtype,
        device=device)
    f = single_state(f_batched)
    Df = single_state(Df_batched)
    f.qgtensor = agotensor
    Df.qgtensor = agotensor

    ret = [f, Df]
    if return_inner_products:
        ret.append((aip, oip, gip))
    if return_qgtensor:
        ret.append(agotensor)
    return ret
