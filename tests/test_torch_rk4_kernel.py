"""The fused RK4 kernel's layouts and plain version against the JAX package:
the row-group layout of every choice of G (the entries, the rows, the
padding and the balance, and the tendency evaluated through it against
``Tendency`` and the JAX tendency), the resident kernel's records evaluated
bit for bit as the layout, the plain version in float32 against
the TPU kernel it replaces (``make_pallas_rk4_f32``, run in interpret
mode), and in float64 against ``make_rk_step``.  On the CPU the wrapper
runs the plain version and launches nothing; the kernel itself is compared
with its plain version only on a CUDA card (marked ``cuda``), where a
traced ``integrate`` also records its launch's spans."""

import copy
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgs_tpu.integrators.rk import make_rk_step, rk4_tableau, time_grid
from qgs_tpu.models.tendencies import create_tendencies as jax_create_tendencies
from qgs_tpu.ops.pallas_kernels import make_pallas_rk4_f32
from qgs_tpu_torch.integrators.rk import integrate_runge_kutta
from qgs_tpu_torch.ops import _build, fused_df_rk4, fused_rk4
from qgs_tpu_torch.ops.contraction import from_numpy
from qgs_tpu_torch.ops.twofloat import DfTendency, df_from_f64
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


LAYOUT_GROUPS = (1, 2, 4, 8)     # the G the layout is checked at


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


@pytest.mark.parametrize("groups", LAYOUT_GROUPS)
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


@pytest.mark.parametrize("groups", LAYOUT_GROUPS)
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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_resident_records_evaluate_the_tendency(maooam, dtype):
    """The resident K1's 16-byte records (``resident_records``, at the
    layout's own width: its shared-memory bytes are the layout's), decoded
    as the kernel decodes them (``streamed_tendency``), give
    ``group_tendency``'s tendency bit for bit in the state's dtype."""
    pars, _, tensor = maooam
    lay = fused_rk4.group_layout(tensor.coords, tensor.data, tensor.shape,
                                 fused_rk4.K1.groups)
    recs = fused_rk4.resident_records(lay, dtype)
    assert recs.shape == lay.jk.shape + (4,) and recs.dtype == np.int32
    np.testing.assert_array_equal(recs[..., 0], lay.jk)
    np.testing.assert_array_equal(recs[..., 1], lay.ctl)
    x = torch.as_tensor(np.random.default_rng(12).random((5, pars.ndim))
                        * 0.05, dtype=dtype)
    assert torch.equal(fused_rk4.streamed_tendency(recs, lay.lengths, x),
                       fused_rk4.group_tendency(lay, x))


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
@pytest.mark.parametrize("dtype,tol,n_steps", [
    (torch.float64, dict(rtol=1e-9, atol=1e-11), 301),
    (torch.float32, dict(rtol=1e-4, atol=1e-6), 100),
], ids=["f64", "f32"])
def test_kernel_matches_plain_version_on_card(maooam, cuda_device, dtype, tol,
                                              n_steps):
    """The kernel against the float64 plain version on the card: B = 1000
    (a ragged last block), the reference's grid with a shorter last step, a
    record every 7 steps."""
    pars, _, tensor = maooam
    dts = torch.as_tensor(np.diff(time_grid(0., 30.05, 0.1))[:n_steps],
                          device=cuda_device)
    x = torch.as_tensor(np.random.default_rng(1).random((1000, pars.ndim))
                        * 0.01, device=cuda_device)
    before = fused_rk4.launches
    y, rec = fused_rk4.fused_rk4(_port(tensor, dtype, cuda_device),
                                 x.to(dtype), dts, 7)
    torch.cuda.synchronize()
    assert fused_rk4.launches == before + 1
    y_ref, rec_ref = fused_rk4.fused_rk4_reference(
        _port(tensor, torch.float64, cuda_device), x, dts, 7)
    np.testing.assert_allclose(y.double().cpu().numpy(),
                               y_ref.cpu().numpy(), **tol)
    np.testing.assert_allclose(rec.double().cpu().numpy(),
                               rec_ref.cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["resident", "streamed"])
def test_traced_integrate_records_the_launch_spans(maooam, cuda_device,
                                                   kernel, tmp_path,
                                                   monkeypatch):
    """Under ``trace``, each float64 ``integrate`` on the card records
    ``qgs.route`` and ``qgs.layout`` once a launch, and ``qgs.state_in``
    twice (the state, the time grid), on the resident kernel and on the
    streamed one (chosen by a shared-memory limit that only its layout
    fits); the first launch builds the tendency's launch plan (one layout,
    one ``qgs.layout_in``) and the second is served by it (one plan hit);
    the spans are host operations of the trace, none on the device's
    timeline."""
    pars, _, tensor = maooam
    f = _port(tensor, torch.float64, cuda_device)
    if kernel == "streamed":
        limit = fused_rk4.streamed_smem_bytes(
            f.shape[0], fused_rk4.K1.groups, torch.float64)
        monkeypatch.setattr(_build, "max_smem_optin", lambda device: limit)
    assert fused_rk4.launch_plan(f, fused_rk4.K1, torch.float64,
                                 cuda_device).kernel == kernel
    counter = "launches" if kernel == "resident" else "launches_streamed"
    ic = np.random.default_rng(3).random((64, pars.ndim)) * 0.01
    profiling.reset_spans()
    before, builds = getattr(fused_rk4, counter), fused_rk4.layout_builds
    hits = fused_rk4.plan_hits
    with trace(str(tmp_path)):
        for _ in range(2):
            integrate_runge_kutta(f, 0., 1., 0.1, ic=ic, write_steps=5)
        torch.cuda.synchronize()
    totals = profiling.span_totals()
    profiling.reset_spans()
    assert getattr(fused_rk4, counter) - before == 2
    assert fused_rk4.layout_builds - builds == 1
    assert fused_rk4.plan_hits - hits == 1
    assert {name: totals[name][0] for name in (
        "qgs.route", "qgs.layout", "qgs.layout_in")} == {
        "qgs.route": 2, "qgs.layout": 2, "qgs.layout_in": 1}
    assert totals["qgs.state_in"][0] == 4
    (path,) = tmp_path.glob("*.pt.trace.json")
    cats = {e["cat"] for e in json.loads(path.read_text())["traceEvents"]
            if e.get("name", "").startswith("qgs.")}
    assert cats == {"cpu_op"}


# -- the launch plan ----------------------------------------------------------

H100_OPTIN = 232448      # the H100's opt-in shared memory a block (bytes)


def _streamed_limit(f, dtype=torch.float64):
    """A shared-memory limit that only the streamed K1's layout fits."""
    return fused_rk4.streamed_smem_bytes(f.shape[0], fused_rk4.K1.groups,
                                         dtype)


def test_launch_plan_is_built_once_a_key(maooam):
    """Two requests for one key give one plan; its tables are built (one
    ``group_layout``) at the first and served from the plan at the second,
    which counts a plan hit; the plan's choice is ``pick_kernel``'s of its
    layouts' bytes."""
    _, _, tensor = maooam
    f = _port(tensor)
    builds, hits = fused_rk4.layout_builds, fused_rk4.plan_hits
    plan = fused_rk4.launch_plan(f, fused_rk4.K1, torch.float64, "cpu",
                                 limit=H100_OPTIN)
    assert fused_rk4.layout_builds == builds and plan.layout is None
    got = [fused_rk4.plan_tables(f, fused_rk4.K1, None, torch.float64, "cpu",
                                 limit=H100_OPTIN) for _ in range(2)]
    assert fused_rk4.launch_plan(f, fused_rk4.K1, torch.float64,
                                 torch.device("cpu"),
                                 limit=H100_OPTIN) is plan
    assert fused_rk4.layout_builds - builds == 1
    assert fused_rk4.plan_hits - hits == 1
    assert got[0][0] == got[1][0] == plan.kernel == "resident"
    assert all(a is b for a, b in zip(got[0][1], got[1][1]))
    assert plan.sizes == fused_rk4.K1.sizes(f.coords, f.shape[0], 8,
                                            plan.rows.width, torch.float64)
    assert plan.kernel == fused_rk4.pick_kernel(plan.sizes, H100_OPTIN)
    assert list(f.launch_plans.values()) == [plan]


@pytest.mark.parametrize("change", ["groups", "dtype", "limit", "family"])
def test_launch_plan_is_another_for_another_key(maooam, change):
    """Another G, dtype, shared-memory limit or kernel family gives another
    plan beside the first, with the choice ``pick_kernel`` makes from that
    family's bytes at that G, dtype and limit."""
    _, _, tensor = maooam
    f = _port(tensor)
    args = dict(family=fused_rk4.K1, dtype=torch.float64,
                groups=fused_rk4.K1.groups, limit=H100_OPTIN)
    first = fused_rk4.launch_plan(f, device="cpu", **args)
    args.update({"groups": dict(groups=4), "dtype": dict(dtype=torch.float32),
                 "limit": dict(limit=_streamed_limit(f)),
                 "family": dict(family=fused_df_rk4.DF,
                                dtype=torch.float32)}[change])
    other = fused_rk4.launch_plan(f, device="cpu", **args)
    assert other is not first and len(f.launch_plans) == 2
    assert fused_rk4.launch_plan(f, device="cpu", **args) is other
    width = fused_rk4.row_groups(f.coords, f.shape[0], args["groups"]).width
    sizes = args["family"].sizes(f.coords, f.shape[0], args["groups"],
                                 width, args["dtype"])
    assert other.kernel == fused_rk4.pick_kernel(sizes, args["limit"])
    assert other.kernel == ("streamed" if change == "limit" else "resident")


@pytest.mark.parametrize("array", ["data", "coords"])
def test_launch_plan_follows_a_reassigned_tensor(maooam, array):
    """Reassigning ``f.data`` (or ``f.coords``) gives a new plan whose
    tables are the new tensor's, and drops the old plans; a change inside
    the arrays in place is not seen."""
    _, _, tensor = maooam
    f = _port(tensor)
    key = (fused_rk4.K1, None, torch.float64, "cpu")
    old = fused_rk4.launch_plan(f, fused_rk4.K1, torch.float64, "cpu",
                                limit=H100_OPTIN)
    fused_rk4.plan_tables(f, *key, limit=H100_OPTIN)
    fused_rk4.launch_plan(f, fused_rk4.K1, torch.float32, "cpu",
                          limit=H100_OPTIN)
    first = f.data[0]
    f.data[0] = 1.              # in place: the same arrays, the same plan
    assert fused_rk4.launch_plan(f, fused_rk4.K1, torch.float64, "cpu",
                                 limit=H100_OPTIN) is old
    f.data[0] = first
    if array == "data":
        f.data = f.data * 2
    else:
        f.coords = f.coords.copy()
    builds = fused_rk4.layout_builds
    _, tables = fused_rk4.plan_tables(f, *key, limit=H100_OPTIN)
    new = fused_rk4.launch_plan(f, fused_rk4.K1, torch.float64, "cpu",
                                limit=H100_OPTIN)
    assert new is not old and list(f.launch_plans.values()) == [new]
    assert fused_rk4.layout_builds - builds == 1
    assert new.data is f.data and new.coords is f.coords
    scale = 2. if array == "data" else 1.
    vals = np.ascontiguousarray(tables[1].numpy()[..., 2:]).view("<f8")
    np.testing.assert_array_equal(vals[..., 0], old.layout.vals * scale)


@pytest.mark.parametrize("family, dtype, kernel", [
    ("K1", torch.float64, "resident"), ("K1", torch.float32, "resident"),
    ("K1", torch.float64, "streamed"), ("K1", torch.float32, "streamed"),
    ("DF", torch.float32, "resident"), ("DF", torch.float32, "streamed"),
])
def test_plan_tables_equal_the_layout(maooam, family, dtype, kernel):
    """A plan's tables, built on the CPU, are ``group_layout``'s as the
    kernel reads them bit for bit, in the launcher's order: K1's packed
    records (``resident_records``, ``streamed_records``, values in the
    state's dtype), K2's resident tables (values as their (hi, lo) split)
    and ``df_streamed_records``; a forced kernel gets its own tables in the
    same plan."""
    _, _, tensor = maooam
    f = _port(tensor)
    fam = fused_rk4.K1 if family == "K1" else fused_df_rk4.DF
    got, tables = fused_rk4.plan_tables(f, fam, kernel, dtype, "cpu",
                                        limit=H100_OPTIN)
    lay = fused_rk4.group_layout(f.coords, f.data, f.shape, fam.groups)
    if kernel == "streamed":
        recs = (fused_rk4.streamed_records(lay, dtype) if family == "K1"
                else fused_df_rk4.df_streamed_records(lay))
        want = (lay.lengths, recs)
    elif family == "K1":
        want = (lay.lengths, fused_rk4.resident_records(lay, dtype))
    else:
        want = (lay.lengths, lay.jk, lay.ctl,
                *fused_df_rk4.split_values(lay.vals))
    assert got == kernel and len(tables) == len(want)
    for t, w in zip(tables, want):
        w = torch.as_tensor(w)
        assert t.device.type == "cpu" and t.dtype == w.dtype
        assert torch.equal(t, w)
    plan = fused_rk4.launch_plan(f, fam, dtype, "cpu", limit=H100_OPTIN)
    assert plan.kernel == "resident" and list(plan.tables) == [kernel]
    for a, b in zip(plan.layout, lay):
        np.testing.assert_array_equal(a, b)


def test_plan_without_a_kernel_raises(maooam):
    """A limit that neither kernel fits: the plan's choice is None, and a
    launch's tables raise the launcher's error, naming that limit."""
    _, _, tensor = maooam
    f = _port(tensor)
    plan = fused_rk4.launch_plan(f, fused_rk4.K1, torch.float64, "cpu",
                                 limit=1024)
    assert plan.kernel is None and plan.layout is None
    with pytest.raises(RuntimeError, match="neither the resident.*the 1024 B"):
        fused_rk4.plan_tables(f, fused_rk4.K1, None, torch.float64, "cpu",
                              limit=1024)


def test_a_copy_of_the_module_builds_its_own_plans(maooam):
    """A mesh's replica (``copy.deepcopy`` of the module) starts without
    plans, and the original keeps its own."""
    _, _, tensor = maooam
    f = _port(tensor)
    plan = fused_rk4.launch_plan(f, fused_rk4.K1, torch.float64, "cpu",
                                 limit=H100_OPTIN)
    g = copy.deepcopy(f)
    assert len(g.launch_plans) == 0
    assert list(f.launch_plans.values()) == [plan]
    assert fused_rk4.launch_plan(g, fused_rk4.K1, torch.float64, "cpu",
                                 limit=H100_OPTIN) is not plan


def _k1_run(f, y, dts, kernel):
    out = fused_rk4.K1.launch(f, y, dts, 7, kernel)
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["resident", "streamed"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_stored_plan_launches_bit_equal(maooam, cuda_device, dtype, kernel):
    """K1 launched from a stored plan (the second launch of one module,
    a plan hit) is bit-equal to a launch from a fresh module of the same
    tensor, on the resident and on the streamed kernel (forced)."""
    pars, _, tensor = maooam
    f = _port(tensor, dtype, cuda_device)
    dts = torch.full((50,), 0.1, dtype=torch.float64, device=cuda_device)
    y = torch.as_tensor(np.random.default_rng(9).random((100, pars.ndim))
                        * 0.01, dtype=dtype, device=cuda_device)
    _k1_run(f, y, dts, kernel)
    hits = fused_rk4.plan_hits
    got = _k1_run(f, y, dts, kernel)
    assert fused_rk4.plan_hits - hits == 1
    fresh = _k1_run(_port(tensor, dtype, cuda_device), y, dts, kernel)
    assert all(torch.equal(a, b) for a, b in zip(got, fresh))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["resident", "streamed"])
def test_stored_plan_launches_bit_equal_k2(maooam, cuda_device, kernel):
    """The same for K2, resident and streamed (forced), on a
    ``DfTendency``."""
    pars, _, tensor = maooam
    make = lambda: DfTendency(tensor.coords, tensor.data, tensor.shape,
                              device=cuda_device)
    f = make()
    dts = torch.full((50,), 0.1, dtype=torch.float64, device=cuda_device)
    y = df_from_f64(torch.as_tensor(
        np.random.default_rng(10).random((100, pars.ndim)) * 0.01,
        device=cuda_device))

    def run(g):
        out = fused_df_rk4.DF.launch(g, y, dts, 7, kernel)
        torch.cuda.synchronize()
        return [t for pair in out for t in pair]

    run(f)
    hits = fused_rk4.plan_hits
    got = run(f)
    assert fused_rk4.plan_hits - hits == 1
    assert all(torch.equal(a, b) for a, b in zip(got, run(make())))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["resident", "streamed"])
def test_launch_follows_reassigned_data(maooam, cuda_device, kernel):
    """After ``f.data`` is reassigned, K1's result is the new tensor's:
    bit-equal to a fresh module's of the new values, and not the old
    result."""
    pars, _, tensor = maooam
    f = _port(tensor, torch.float64, cuda_device)
    dts = torch.full((50,), 0.1, dtype=torch.float64, device=cuda_device)
    y = torch.as_tensor(np.random.default_rng(11).random((64, pars.ndim))
                        * 0.01, device=cuda_device)
    old = _k1_run(f, y, dts, kernel)
    f.data = f.data * 1.5
    got = _k1_run(f, y, dts, kernel)
    fresh = from_numpy(tensor.coords, tensor.data * 1.5, tensor.shape,
                       torch.float64, cuda_device)
    assert all(torch.equal(a, b)
               for a, b in zip(got, _k1_run(fresh, y, dts, kernel)))
    assert not torch.equal(got[0], old[0])
