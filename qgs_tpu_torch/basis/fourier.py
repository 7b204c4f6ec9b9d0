"""
Fourier basis definitions
=========================

Channel and closed-basin Fourier bases (ref
``qgs/basis/fourier.py:27-282``).  Mode catalogue:

* ``A``:  sqrt(2) cos(P y)
* ``K``:  2 cos(M n x) sin(P y)
* ``L``:  2 sin(H n x) sin(P y)          (basin: half-integer x-wavenumber)

The analytic inner-product layer works directly from the vectorized
wavenumber table (:class:`WaveNumbers`) — a struct-of-arrays layout that the
closed-form Kronecker/parity formulas consume with NumPy broadcasting
instead of per-element Python loops.
"""

from __future__ import annotations

import numpy as np
from sympy import symbols, sin, cos, sqrt

from qgs_tpu_torch.basis.base import SymbolicBasis

_x, _y = symbols('x y')
_n = symbols('n', positive=True)

# type codes for the struct-of-arrays wavenumber table
TYPE_A, TYPE_K, TYPE_L = 0, 1, 2
_TYPE_CHARS = np.array(['A', 'K', 'L'])


class WaveNumbers:
    """Vectorized wavenumber table: arrays ``typ`` (0=A,1=K,2=L), ``P``, ``M``,
    ``H`` (integers) and ``nx``, ``ny`` (floats), one entry per mode."""

    def __init__(self, typ, P, M, H, nx, ny):
        self.typ = np.asarray(typ, dtype=np.int64)
        self.P = np.asarray(P, dtype=np.int64)
        self.M = np.asarray(M, dtype=np.int64)
        self.H = np.asarray(H, dtype=np.int64)
        self.nx = np.asarray(nx, dtype=np.float64)
        self.ny = np.asarray(ny, dtype=np.float64)

    def __len__(self):
        return len(self.typ)

    def __getitem__(self, i):
        return WaveNumber(_TYPE_CHARS[self.typ[i]], int(self.P[i]), int(self.M[i]),
                          int(self.H[i]), float(self.nx[i]), float(self.ny[i]))

    def __repr__(self):
        return "\n".join(repr(self[i]) for i in range(len(self)))


class WaveNumber:
    """A single mode's wavenumber record (scalar view into :class:`WaveNumbers`)."""

    def __init__(self, function_type, P, M, H, nx, ny):
        self.type = function_type
        self.P = P
        self.M = M
        self.H = H
        self.nx = nx
        self.ny = ny

    def __repr__(self):
        return (f"type = {self.type}, P = {self.P}, M= {self.M},"
                f"H={self.H}, nx= {self.nx}, ny={self.ny}")


def channel_wavenumbers(spectral_blocks) -> WaveNumbers:
    """Expand (nx, ny) spectral blocks into channel modes: blocks with
    x-wavenumber 1 yield the three modes A, K, L; others yield K, L."""
    typ, P, M, H, nx, ny = [], [], [], [], [], []
    for bnx, bny in np.asarray(spectral_blocks):
        if bnx == 1:
            typ.append(TYPE_A); P.append(bny); M.append(0); H.append(0); nx.append(0.); ny.append(bny)
        typ.append(TYPE_K); P.append(bny); M.append(bnx); H.append(0); nx.append(bnx); ny.append(bny)
        typ.append(TYPE_L); P.append(bny); M.append(0); H.append(bnx); nx.append(bnx); ny.append(bny)
    return WaveNumbers(typ, P, M, H, nx, ny)


def basin_wavenumbers(spectral_blocks) -> WaveNumbers:
    """Expand (nx, ny) spectral blocks into closed-basin modes: L-type with
    half-integer x-wavenumbers."""
    typ, P, M, H, nx, ny = [], [], [], [], [], []
    for bnx, bny in np.asarray(spectral_blocks):
        typ.append(TYPE_L); P.append(bny); M.append(0); H.append(bnx); nx.append(bnx / 2.); ny.append(bny)
    return WaveNumbers(typ, P, M, H, nx, ny)


def fourier_function(wave_number: WaveNumber):
    """SymPy expression of a single Fourier mode."""
    if wave_number.type == 'A':
        return sqrt(2) * cos(wave_number.ny * _y)
    if wave_number.type == 'K':
        return 2 * cos(wave_number.nx * _n * _x) * sin(wave_number.ny * _y)
    if wave_number.type == 'L':
        return 2 * sin(wave_number.nx * _n * _x) * sin(wave_number.ny * _y)
    return None


# backward-compatible alias matching the reference API name
fourier_functions = fourier_function


class ChannelFourierBasis(SymbolicBasis):
    """Fourier basis on a zonally periodic channel (no-flux at y boundaries)."""

    def __init__(self, spectral_blocks, aspect_ratio):
        SymbolicBasis.__init__(self)
        self.substitutions.append((_n, aspect_ratio))
        self.wavenumbers = channel_wavenumbers(spectral_blocks)
        for i in range(len(self.wavenumbers)):
            self.functions.append(fourier_function(self.wavenumbers[i]))


class BasinFourierBasis(SymbolicBasis):
    """Fourier basis on a closed basin (no-flux at all boundaries)."""

    def __init__(self, spectral_blocks, aspect_ratio):
        SymbolicBasis.__init__(self)
        self.substitutions.append((_n, aspect_ratio))
        self.wavenumbers = basin_wavenumbers(spectral_blocks)
        for i in range(len(self.wavenumbers)):
            self.functions.append(fourier_function(self.wavenumbers[i]))


def _contiguous_blocks(nxmax, nymax):
    blocks = np.zeros((nxmax * nymax, 2), dtype=int)
    i = 0
    for nx in range(1, nxmax + 1):
        for ny in range(1, nymax + 1):
            blocks[i] = (nx, ny)
            i += 1
    return blocks


def contiguous_channel_basis(nxmax, nymax, aspect_ratio):
    """Channel basis for the contiguous block set up to (nxmax, nymax)."""
    return ChannelFourierBasis(_contiguous_blocks(nxmax, nymax), aspect_ratio)


def contiguous_basin_basis(nxmax, nymax, aspect_ratio):
    """Closed-basin basis for the contiguous block set up to (nxmax, nymax)."""
    return BasinFourierBasis(_contiguous_blocks(nxmax, nymax), aspect_ratio)
