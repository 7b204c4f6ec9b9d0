"""The numbers that decide ``correct``, each the widest gap of the
program's output from the plain reference's, and the reservoir that
draws the compared calls from the seed.

A gap that cannot be computed (other shapes, a value that is not finite)
is infinite, so that it fails every limit."""

from __future__ import annotations

import math

import numpy as np
import torch

TINY = 1e-300


def _pair(got, ref):
    got = torch.as_tensor(got).to(torch.float64)
    ref = torch.as_tensor(ref).to(device=got.device, dtype=torch.float64)
    return got, ref


def _finite(value):
    value = float(value)
    return value if math.isfinite(value) else math.inf


def tensor_gap(coords, data, ref_coords, ref_data):
    """The widest gap between two COO tensors over the union of their
    entries (an entry one of them lacks counts as 0 there), over the
    reference's largest |value|."""
    def summed(c, d):
        keys, inv = np.unique(np.ascontiguousarray(np.asarray(c).T),
                              axis=0, return_inverse=True)
        sums = np.zeros(len(keys))
        np.add.at(sums, inv.ravel(), np.asarray(d, np.float64))
        return {tuple(k): v for k, v in zip(keys.tolist(), sums)}
    got, ref = summed(coords, data), summed(ref_coords, ref_data)
    scale = max(abs(v) for v in ref.values())
    gap = max(abs(got.get(k, 0.0) - ref.get(k, 0.0))
              for k in set(got) | set(ref))
    return _finite(gap / scale)


def var_gap(got, ref, var_axis=1):
    """The widest gap of a state-like output ((B, n, T) records or (B, n)
    states), each variable's over its largest |value| in the reference."""
    got, ref = _pair(got, ref)
    if got.shape != ref.shape:
        return math.inf
    axes = [a for a in range(ref.dim()) if a != var_axis % ref.dim()]
    diff = (got - ref).abs().amax(dim=axes)
    scale = ref.abs().amax(dim=axes).clamp_min(TINY)
    return _finite(torch.nan_to_num((diff / scale).max(), nan=math.inf))


def scaled_gap(got, ref):
    """The widest gap over the reference's largest |value|."""
    got, ref = _pair(got, ref)
    if got.shape != ref.shape:
        return math.inf
    gap = (got - ref).abs().max() / ref.abs().max().clamp_min(TINY)
    return _finite(torch.nan_to_num(gap, nan=math.inf))


def column_gap(got, ref, vec_axis=1):
    """The widest gap between two blocks of unit vectors (the vector's
    components along ``vec_axis``), each of the program's columns taken
    with the sign that brings it nearest the reference's: a QR may flip a
    column's sign."""
    got, ref = _pair(got, ref)
    if got.shape != ref.shape:
        return math.inf
    sign = torch.where((got * ref).sum(dim=vec_axis, keepdim=True) < 0,
                       -1.0, 1.0)
    gap = (got - sign * ref).abs().max()
    return _finite(torch.nan_to_num(gap, nan=math.inf))


class Reservoir:
    """``k`` items drawn uniformly by ``rng`` from a stream whose length is
    not known beforehand (Algorithm R)."""

    def __init__(self, k, rng):
        self.k, self.rng, self.seen, self.kept = k, rng, 0, []

    def offer(self, item):
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            slot = int(self.rng.integers(self.seen))
            if slot < self.k:
                self.kept[slot] = item

    def items(self):
        return list(self.kept)
