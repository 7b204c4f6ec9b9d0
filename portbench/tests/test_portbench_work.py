"""The copied work counts on MAOOAM 36 (PERF.md §6's kernel table: 4,132
operations a trajectory-step, 1.991 ms bound at B = 16384 x 1000 steps in
float64) and the tangent window's count against the reference's
Jacobian."""


import numpy as np
import pytest
import torch

from portbench.harness import loader, work
from portbench.reference import qg


@pytest.fixture(scope="module")
def tensor():
    return qg.load_tensor(loader.config("maooam36"))


def test_entry_ops(tensor):
    assert work.entry_ops(tensor.coords, (3, 2, 1)) == (907, 351)
    assert work.rk4_ops(36, tensor.coords) == 4132


def test_bound_at_phase_5s_shapes(tensor):
    flops, n_bytes = work.rk4_work(16384, 36, tensor.coords, 1000, 8)
    seconds, which = work.bound_s(flops, n_bytes, work.PEAK_F64_VECTOR)
    assert (round(seconds * 1e3, 3), which) == (1.991, "operations")
    f32 = work.bound_s(*work.rk4_work(16384, 36, tensor.coords, 1000, 4),
                       work.PEAK_F32_VECTOR)[0]
    assert round(f32 * 1e3, 3) == 1.010


def test_records_add_their_bytes(tensor):
    base = work.rk4_work(4096, 36, tensor.coords, 10000, 8)
    with_records = work.rk4_work(4096, 36, tensor.coords, 10000, 8,
                                 records=100)
    assert with_records[0] == base[0]
    assert with_records[1] - base[1] == 8 * 4096 * 36 * 100


def test_jacobian_terms_match_the_reference(tensor):
    varying, nnz = work.jacobian_terms(tensor.coords)
    f = qg.Quadratic(tensor)
    x = torch.as_tensor(np.random.default_rng(0).random((3, 36)) + 0.5)
    J = f.jacobian(x)
    assert nnz == int((J != 0).any(dim=0).sum())
    # a varying term moves with the state; the constant part does not
    assert varying > 0 and not torch.equal(J[0], J[1])


def test_householder_and_window(tensor):
    assert work.householder_qr_ops(36, 36) == round(8 / 3 * 36 ** 3)
    one = work.tgls_window_ops(36, tensor.coords, 36, 1)
    two = work.tgls_window_ops(36, tensor.coords, 36, 2)
    assert two - one == one - work.householder_qr_ops(36, 36) - 72
