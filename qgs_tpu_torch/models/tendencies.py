"""
Tendencies factory
==================

Counterpart of :mod:`qgs_tpu.models.tendencies`: ``create_tendencies``
builds the inner products and the tendency tensor on the host (the port's
NumPy/SymPy layers, :mod:`qgs_tpu_torch.inner_products` and
:mod:`qgs_tpu_torch.tensors`; rank 3, or rank 5 for the
dynamic-T and T4 configurations) and returns the PyTorch tendency ``f(t,
x)`` and Jacobian ``Df(t, x)`` on single states, with their batched
versions attached as ``.batched`` and the tensor object as ``.qgtensor``.
``create_atmo_thermo_tendencies`` builds the thermodynamic part of the
atmospheric tendencies alone.
"""

from __future__ import annotations

import torch

from qgs_tpu_torch.inner_products.analytic import (
    AtmosphericAnalyticInnerProducts, GroundAnalyticInnerProducts,
    OceanicAnalyticInnerProducts,
)
from qgs_tpu_torch.inner_products.symbolic import (
    AtmosphericSymbolicInnerProducts, GroundSymbolicInnerProducts,
    OceanicSymbolicInnerProducts,
)
from qgs_tpu_torch.tensors.atmo_thermo import (
    AtmoThermoTensor, AtmoThermoTensorDynamicT, AtmoThermoTensorT4,
)
from qgs_tpu_torch.tensors.qgtensor import (QgsTensor, QgsTensorDynamicT,
                                            QgsTensorT4)
from qgs_tpu_torch.ops.contraction import make_tendency_fns, single_state


def _build_inner_products(params):
    """Pick analytic or symbolic inner products from the configuration
    (same choice as ``qgs_tpu.models.tendencies._build_inner_products``).
    A dynamic-T or T4 configuration needs symbolic inner products: the
    analytic ones have no quartic coefficients."""
    if params.T4 or params.dynamic_T:
        blocks = [("atmospheric", params.ablocks),
                  ("oceanic", params.oblocks), ("ground", params.gblocks)]
        used = [name for name, b in blocks if b is not None]
        if used:
            raise ValueError(
                "dynamic_T/T4 configurations need symbolic inner products: "
                f"set the {'/'.join(used)} modes with mode='symbolic' "
                "(analytic inner products have no quartic coefficients)")
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
    """The configuration's tendency tensor: T4, dynamic-T or rank 3."""
    if params.T4:
        return QgsTensorT4(params, aip, oip, gip)
    if params.dynamic_T:
        return QgsTensorDynamicT(params, aip, oip, gip)
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


def create_atmo_thermo_tendencies(params, return_atmo_thermo_tensor=False,
                                  mode="auto", dtype=torch.float64,
                                  device="cuda"):
    """The thermodynamic-only atmospheric tendencies ``f_thermo(t, x)`` on
    single states, the batched version as ``.batched`` (the diagnostics
    take the vertical velocity omega from ``f - f_thermo``), on ``device``
    in ``dtype`` as :func:`create_tendencies`.  With
    ``return_atmo_thermo_tensor``, ``[f_thermo, tensor]``."""
    aip, oip, gip = _build_inner_products(params)
    if params.T4:
        tensor = AtmoThermoTensorT4(params, aip, oip, gip)
    elif params.dynamic_T:
        tensor = AtmoThermoTensorDynamicT(params, aip, oip, gip)
    else:
        tensor = AtmoThermoTensor(params, aip, oip, gip)

    f_batched, _ = make_tendency_fns(tensor.tensor, tensor.jacobian_tensor,
                                     mode=mode, dtype=dtype, device=device)
    f = single_state(f_batched)
    if return_atmo_thermo_tensor:
        return [f, tensor]
    return f
