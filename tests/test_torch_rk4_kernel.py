"""The fused RK4 kernel's layouts and plain version against the JAX package:
the row-group layout of every choice of G (the entries, the rows, the
padding and the balance, and the tendency evaluated through it against
``Tendency`` and the JAX tendency), the plain version in float32 against
the TPU kernel it replaces (``make_pallas_rk4_f32``, run in interpret
mode), and in float64 against ``make_rk_step``.  On the CPU the wrapper
runs the plain version and launches nothing; the kernel itself is compared
with its plain version only on a CUDA card (marked ``cuda``), where a
traced ``integrate`` also records its launch's spans."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgs_tpu.integrators.rk import make_rk_step, rk4_tableau, time_grid
from qgs_tpu.models.tendencies import create_tendencies as jax_create_tendencies
from qgs_tpu.ops.pallas_kernels import make_pallas_rk4_f32
from qgs_tpu_torch.integrators.rk import integrate_runge_kutta
from qgs_tpu_torch.ops import _build, fused_rk4
from qgs_tpu_torch.ops.contraction import from_numpy
from qgs_tpu_torch.utils import profiling
from qgs_tpu_torch.utils.profiling import trace

from tests.test_trajectory import _maooam_params, _rp_params


@pytest.fixture(scope="module")
def maooam():
    pars = _maooam_params()
    f, _, qgt = jax_create_tendencies(pars, return_qgtensor=True)
    return pars, f, qgt.tensor


def _port(tensor, dtype=torch.float64, device="cpu"):
    return from_numpy(tensor.coords, tensor.data, tensor.shape, dtype, device)


@pytest.mark.parametrize("make_params", [_maooam_params, _rp_params],
                         ids=["maooam", "rp"])
def test_csr_layout_reproduces_the_tendency(make_params):
    """The kernel's row-sorted layout, summed row by row in NumPy, gives the
    tendency of the COO tensor."""
    pars = make_params()
    f, _, qgt = jax_create_tendencies(pars, return_qgtensor=True)
    t = qgt.tensor
    row_ptr, jk, vals = fused_rk4.csr_layout(t.coords, t.data, t.shape)
    n1 = t.shape[0]
    assert row_ptr.dtype == np.int32 and jk.dtype == np.int32
    assert row_ptr[0] == 0 and row_ptr[1] == 0          # dummy row dropped
    assert row_ptr[-1] == jk.size == vals.size == np.sum(t.coords[0] != 0)
    x = np.random.default_rng(5).random((3, pars.ndim)) * 0.05
    xx = np.concatenate([np.ones((3, 1)), x], axis=1)
    j, k = jk & 0xffff, jk >> 16
    out = np.zeros((3, n1))
    for r in range(n1):
        e = slice(row_ptr[r], row_ptr[r + 1])
        out[:, r] = (vals[e] * xx[:, j[e]] * xx[:, k[e]]).sum(axis=1)
    np.testing.assert_allclose(out[:, 1:], np.asarray(f.batched(0., x)),
                               rtol=1e-12, atol=1e-14)


def _layout_and_csr(tensor, groups):
    lay = fused_rk4.group_layout(tensor.coords, tensor.data, tensor.shape,
                                 groups)
    return lay, fused_rk4.csr_layout(tensor.coords, tensor.data,
                                     tensor.shape)


@pytest.mark.parametrize("groups", fused_rk4.GROUPS)
def test_group_layout_places_every_entry_once(maooam, groups):
    """Every entry is in exactly one place, in its row's slot; each row lives
    in one group, padded with zero entries to whole chunks, its last chunk
    flagged; the records past a group's length are zero; and the groups'
    lengths differ by at most one row's records."""
    _, _, tensor = maooam
    lay, (row_ptr, jk, vals) = _layout_and_csr(tensor, groups)
    n = tensor.shape[0] - 1
    C = fused_rk4.CHUNK
    counts = np.diff(row_ptr)[1:]
    padded = np.maximum(-(-counts // C), 1) * C
    assert lay.jk.shape == lay.ctl.shape == lay.vals.shape
    assert lay.jk.shape[0] == groups and lay.group_of_row.shape == (n,)
    assert lay.jk.dtype == lay.ctl.dtype == lay.lengths.dtype == np.int32
    seen = []
    for g in range(groups):
        L = int(lay.lengths[g])
        assert L % C == 0 and lay.jk.shape[1] >= L + fused_rk4.AHEAD * C
        for a in (lay.jk, lay.ctl, lay.vals):
            assert not a[g, L:].any()
        rows = lay.ctl[g, :L] & (fused_rk4.LAST - 1)
        assert np.all(np.diff(rows) >= 0)
        for i in np.unique(rows):
            assert lay.group_of_row[i] == g
            at = np.flatnonzero(rows == i)
            assert at.size == padded[i] and np.all(np.diff(at) == 1)
            e = slice(row_ptr[i + 1], row_ptr[i + 2])
            assert np.array_equal(lay.jk[g, at[:counts[i]]], jk[e])
            assert np.array_equal(lay.vals[g, at[:counts[i]]], vals[e])
            assert not lay.jk[g, at[counts[i]:]].any()
            assert not lay.vals[g, at[counts[i]:]].any()
            last = (lay.ctl[g, at] & fused_rk4.LAST) != 0
            assert last[-C:].all() and not last[:-C].any()
            seen.append(int(i))
    assert sorted(seen) == list(range(n))
    assert int(lay.lengths.sum()) == int(padded.sum())
    assert int(lay.lengths.max() - lay.lengths.min()) <= int(padded.max())


@pytest.mark.parametrize("groups", fused_rk4.GROUPS)
def test_group_tendency_matches_tendency_and_jax(maooam, groups):
    pars, f, tensor = maooam
    lay = fused_rk4.group_layout(tensor.coords, tensor.data, tensor.shape,
                                 groups)
    x = np.random.default_rng(8).random((5, pars.ndim)) * 0.05
    out = fused_rk4.group_tendency(lay, torch.as_tensor(x))
    assert out.dtype == torch.float64 and out.shape == (5, pars.ndim)
    np.testing.assert_allclose(out.numpy(),
                               _port(tensor)(0., torch.as_tensor(x)).numpy(),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(out.numpy(), np.asarray(f.batched(0., x)),
                               rtol=1e-12, atol=1e-14)


def test_group_layout_writes_rows_without_entries():
    """A row with no entries still gets a chunk (of zero entries), so that
    the kernel writes its stage values; its tendency is 0."""
    coords = np.array([[1, 1, 3, 3, 3], [0, 1, 2, 3, 0], [1, 1, 3, 0, 0]])
    data = np.array([1., 2., 3., 4., 5.])
    lay = fused_rk4.group_layout(coords, data, (4, 4, 4), 2)
    rows = [sorted(set((lay.ctl[g, :L] & (fused_rk4.LAST - 1)).tolist()))
            for g, L in enumerate(lay.lengths)]
    assert sorted(rows[0] + rows[1]) == [0, 1, 2]
    assert lay.lengths.tolist() == [4, 4]           # rows 2 | 0 and 1
    x = torch.tensor([[0.5, -2., 3.]], dtype=torch.float64)
    out = fused_rk4.group_tendency(lay, x)
    ref = from_numpy(coords, data, (4, 4, 4), device="cpu")(0., x)
    assert torch.equal(out, ref) and out[0, 1] == 0


def test_reference_f32_matches_pallas_kernel(maooam):
    pars, _, tensor = maooam
    x = np.random.default_rng(4).random((8, pars.ndim)) * 0.05
    run = make_pallas_rk4_f32(tensor, 0.1, n_steps=10, batch_block=4,
                              interpret=True)
    y_pallas = np.asarray(run(jnp.asarray(x, jnp.float32)))

    f32 = _port(tensor, torch.float32)
    y, rec = fused_rk4.fused_rk4_reference(
        f32, torch.as_tensor(x, dtype=torch.float32), np.full(10, 0.1))
    assert y.dtype == torch.float32 and rec.shape == (0, 8, pars.ndim)
    np.testing.assert_allclose(y.numpy(), y_pallas, rtol=1e-5, atol=1e-7)


def test_reference_f64_matches_jax_rk_step(maooam):
    """Step by step on the reference's grid (a shorter last step), with the
    records of every third step."""
    pars, f, tensor = maooam
    x = np.random.default_rng(6).random((4, pars.ndim)) * 0.01
    grid = time_grid(0., 2.05, 0.1)
    dts = np.diff(grid)
    step = make_rk_step(f.batched, *rk4_tableau())
    ys, y = [], jnp.asarray(x)
    for tt, dt in zip(grid[:-1], dts):
        y = step(y, tt, dt)
        ys.append(np.asarray(y))

    y_ref, rec = fused_rk4.fused_rk4_reference(_port(tensor),
                                               torch.as_tensor(x), dts, 3)
    np.testing.assert_allclose(y_ref.numpy(), ys[-1], rtol=1e-12, atol=1e-14)
    assert rec.shape == (len(dts) // 3, 4, pars.ndim)
    np.testing.assert_allclose(rec.numpy(), np.stack(ys[2::3]), rtol=1e-12,
                               atol=1e-14)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing(maooam):
    pars, _, tensor = maooam
    f = _port(tensor)
    x = torch.as_tensor(np.random.default_rng(7).random((3, pars.ndim)) * 0.01)
    dts = torch.full((12,), 0.1, dtype=torch.float64)
    before = fused_rk4.launches
    y, rec = fused_rk4.fused_rk4(f, x, dts, 5)
    y_ref, rec_ref = fused_rk4.fused_rk4_reference(f, x, dts, 5)
    assert fused_rk4.launches == before == 0
    assert torch.equal(y, y_ref) and torch.equal(rec, rec_ref)
    assert rec.shape == (2, 3, pars.ndim)
    assert not torch.equal(y, x)                  # the input is not modified


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused RK4 kernel has no CPU build")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", fused_rk4.GROUPS)
@pytest.mark.parametrize("dtype,tol,n_steps", [
    (torch.float64, dict(rtol=1e-9, atol=1e-11), 301),
    (torch.float32, dict(rtol=1e-4, atol=1e-6), 100),
], ids=["f64", "f32"])
def test_kernel_matches_plain_version_on_card(maooam, cuda_device, dtype, tol,
                                              n_steps, groups):
    """The kernel against the float64 plain version on the card, for every
    G: B = 1000 (a ragged last block), the reference's grid with a shorter
    last step, a record every 7 steps."""
    pars, _, tensor = maooam
    dts = torch.as_tensor(np.diff(time_grid(0., 30.05, 0.1))[:n_steps],
                          device=cuda_device)
    x = torch.as_tensor(np.random.default_rng(1).random((1000, pars.ndim))
                        * 0.01, device=cuda_device)
    before = fused_rk4.launches
    y, rec = fused_rk4.fused_rk4(_port(tensor, dtype, cuda_device),
                                 x.to(dtype), dts, 7, groups=groups)
    torch.cuda.synchronize()
    assert fused_rk4.launches == before + 1
    y_ref, rec_ref = fused_rk4.fused_rk4_reference(
        _port(tensor, torch.float64, cuda_device), x, dts, 7)
    np.testing.assert_allclose(y.double().cpu().numpy(),
                               y_ref.cpu().numpy(), **tol)
    np.testing.assert_allclose(rec.double().cpu().numpy(),
                               rec_ref.cpu().numpy(), **tol)


LAUNCH_SPANS = ("qgs.route", "qgs.layout", "qgs.layout_in")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["resident", "streamed"])
def test_traced_integrate_records_the_launch_spans(maooam, cuda_device,
                                                   kernel, tmp_path,
                                                   monkeypatch):
    """Under ``trace``, each float64 ``integrate`` on the card records
    ``qgs.route``, ``qgs.layout`` and ``qgs.layout_in`` once a launch, and
    ``qgs.state_in`` twice (the state, the time grid), on the resident
    kernel and on the streamed one (chosen by a shared-memory limit that
    only its layout fits); each builds its layout once, and the spans are
    host operations of the trace, none on the device's timeline."""
    pars, _, tensor = maooam
    f = _port(tensor, torch.float64, cuda_device)
    if kernel == "streamed":
        limit = fused_rk4.streamed_smem_bytes(
            f.shape[0], fused_rk4.DEFAULT_GROUPS, torch.float64)
        monkeypatch.setattr(_build, "max_smem_optin", lambda device: limit)
    assert fused_rk4.choose_kernel(f, torch.float64, cuda_device) == kernel
    counter = "launches" if kernel == "resident" else "launches_streamed"
    ic = np.random.default_rng(3).random((64, pars.ndim)) * 0.01
    profiling.reset_spans()
    before, builds = getattr(fused_rk4, counter), fused_rk4.layout_builds
    with trace(str(tmp_path)):
        for _ in range(2):
            integrate_runge_kutta(f, 0., 1., 0.1, ic=ic, write_steps=5)
        torch.cuda.synchronize()
    totals = profiling.span_totals()
    profiling.reset_spans()
    assert getattr(fused_rk4, counter) - before == 2
    assert fused_rk4.layout_builds - builds == 2
    assert {name: totals[name][0] for name in LAUNCH_SPANS} == dict.fromkeys(
        LAUNCH_SPANS, 2)
    assert totals["qgs.state_in"][0] == 4
    (path,) = tmp_path.glob("*.pt.trace.json")
    cats = {e["cat"] for e in json.loads(path.read_text())["traceEvents"]
            if e.get("name", "").startswith("qgs.")}
    assert cats == {"cpu_op"}
