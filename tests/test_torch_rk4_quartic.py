"""K5, the fused rank-5 RK4 kernel (``ops/fused_rk4_quartic.py``; the
resident kernel of ``csrc/rk4_fused.cu`` over a four-index entry).

On the CPU: the layout (the packed indices, the rows' groups, the zero
padding, every entry exactly once), its plain twin
``quartic_group_tendency`` against the rank-5 ``Tendency`` (float64 within
1e-13 relative), K5's G, its launch plan beside K1's, and the launcher's
refusals; the paired layout (its pair table, its indices over the
extended stage input, its records, its twin ``paired_group_tendency``),
its shared memory and the launch plan's choice between the two layouts
(the paired one wherever it fits).  On
a CUDA card (marked ``cuda``), each layout: the kernel against the plain
step loop's RK4 step on the T4 and dynamic-T models and on a random
rank-5 tensor, its records, ragged batches, its counters, and a stored
plan's launches bit for bit.  No JAX here: the models are built by the
port's own host layers (``tests/test_torch_rank5.py`` holds K5's
``integrate`` on the card against the JAX package's)."""

import numpy as np
import pytest
import torch

from qgs_tpu_torch.integrators.rk import integrate_runge_kutta
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.ops import _build, contraction, fused_rk4
from qgs_tpu_torch.ops import fused_rk4_quartic as k5
from qgs_tpu_torch.ops.contraction import Tendency
from qgs_tpu_torch.params.params import QgParams

H100_OPTIN = 232448      # the H100's opt-in shared memory a block (bytes)
F64_REL = 1e-13          # the twin against Tendency: summation order only
# the kernel against the plain step loop over 200 steps, float64: summation
# order and FMA contraction only
KERNEL_F64 = dict(rtol=1e-12)
# float32 against the plain float32 loop, relative to the largest |value|
# of the plain float64 loop: both round every operation to float32 (about
# 6e-8), in other orders, and the models carry that over 200 steps.  On an
# H100 the gap read 1.2e-7 (T4, dynamic-T) to 3.4e-7 (the random tensor)
# on 3 seeds, where each float32 loop lies 1.3e-6 to 1.6e-5 from float64
KERNEL_F32 = dict(rtol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread (the suite's parallel workers
    would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def quartic_params(atmosphere=(2, 2), ocean=(2, 4), **scheme):
    """The symbolic ``atmosphere`` channel + ``ocean`` basin (by default
    2x2 + 2x4: ndim 38) with a rank-5 radiation scheme (``T4=True`` or
    ``dynamic_T=True``)."""
    pars = QgParams({'rr': 287.e0, 'sb': 5.6e-8}, **scheme)
    pars.set_params({'kd': 0.04, 'kdp': 0.04, 'n': 1.5})
    pars.set_atmospheric_channel_fourier_modes(*atmosphere, mode='symbolic')
    pars.set_oceanic_basin_fourier_modes(*ocean, mode='symbolic')
    return pars


class COO:
    """A COO tensor: ``coords`` (rank, nnz), ``data`` (nnz,), ``shape``."""

    def __init__(self, coords, data, shape):
        self.coords, self.data, self.shape = coords, data, tuple(shape)


def random_rank5(seed, n1=12, nnz=400):
    """A random rank-5 tensor over ``n1``: quartic entries and entries with
    trailing zeros (cubic to constant), a damping ``-x_i`` on every row
    but the last (which has no entry), duplicates allowed."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, n1 - 1, nnz)
    trail = np.sort(rng.integers(1, n1, (4, nnz)), axis=0)
    trail[:, :nnz // 4] *= rng.random((4, nnz // 4)) < 0.5   # some zeros
    data = rng.standard_normal(nnz) * 0.3
    diag = np.arange(1, n1 - 1)
    coords = np.concatenate([np.stack([rows, *trail]),
                             np.stack([diag, diag] + [0 * diag] * 3)], axis=1)
    data = np.concatenate([data, -np.ones(diag.size)])
    return COO(coords, data, (n1,) * 5)


def states(n, B, seed, dtype=torch.float64, device="cpu", temps=True):
    """B states in [0, 0.01), the 0-th order temperatures of the ndim-38
    models (variables 10 and 29) set near their stationary values."""
    x = np.random.default_rng(seed).random((B, n)) * 0.01
    if temps and n == 38:
        x[:, 10], x[:, 29] = 0.1, 0.12
    return torch.as_tensor(x, dtype=dtype, device=device)


@pytest.fixture(scope="module")
def models():
    """The T4 and dynamic-T tensors (the port's host layers, quadrature
    inner products) and a random rank-5 tensor."""
    out = {}
    for name, scheme in (("t4", dict(T4=True)),
                         ("dynT", dict(dynamic_T=True))):
        _, _, qgt = create_tendencies(quartic_params(**scheme),
                                      return_qgtensor=True, device="cpu")
        T = qgt.tensor
        out[name] = COO(T.coords, T.data, T.shape)
    out["random"] = random_rank5(3)
    return out


MODELS = ["t4", "dynT", "random"]


@pytest.fixture(scope="module")
def dyn_t_114():
    """Dynamic-T on a 4x4 channel over a 4x5 basin (ndim 114): a tensor
    whose paired block does not fit the H100 in float64 while its
    four-gather one does."""
    _, _, qgt = create_tendencies(
        quartic_params((4, 4), (4, 5), dynamic_T=True),
        return_qgtensor=True, device="cpu")
    T = qgt.tensor
    return COO(T.coords, T.data, T.shape)


def _tendency(t, dtype=torch.float64, device="cpu"):
    return Tendency(t.coords, t.data, t.shape, dtype, device)


LAYOUTS = ["resident", "paired"]     # the four-gather and the paired layout


def force_layout(monkeypatch, layout):
    """The launch plan made to take ``layout``: the paired one, which fits
    the T4 and dynamic-T tensors, or the four-gather one, the paired layout
    then given no size (a kernel that cannot take the tensor)."""
    if layout == "resident":
        monkeypatch.setattr(k5, "paired_smem_bytes", lambda *args: None)


# -- the layout --------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_quartic_csr_packs_the_four_indices(models, name):
    """The row-sorted entries: the dummy row dropped, each row's entries in
    COO order, the four trailing indices one byte each of the index word."""
    t = models[name]
    row_ptr, jklm, vals = k5.quartic_csr(t.coords, t.data, t.shape)
    c = np.asarray(t.coords)
    keep = c[0] != 0
    order = np.argsort(c[0][keep], kind="stable")
    assert jklm.dtype == np.int32 and row_ptr[1] == 0
    assert row_ptr[-1] == jklm.size == keep.sum()
    np.testing.assert_array_equal(k5.unpack(jklm), c[1:, keep][:, order])
    np.testing.assert_array_equal(vals, np.asarray(t.data)[keep][order])
    counts = np.bincount(c[0][keep], minlength=t.shape[0])
    np.testing.assert_array_equal(np.diff(row_ptr)[1:], counts[1:])


@pytest.mark.parametrize("groups", [8, 16])
@pytest.mark.parametrize("name", MODELS)
def test_quartic_layout_places_every_entry_once(models, name, groups):
    """Every entry of the tensor (output row 0 dropped) is in exactly one
    group's table, in its row's chunks; the rows are K1's ``row_groups``;
    each row ends on a chunk flagged LAST (a row without entries on one
    chunk of zero entries); past each group's length the records are zero,
    at least one chunk of them."""
    t = models[name]
    n = t.shape[0] - 1
    lay = k5.quartic_layout(t.coords, t.data, t.shape, groups)
    rg = fused_rk4.row_groups(t.coords, t.shape[0], groups)
    np.testing.assert_array_equal(lay.group_of_row, rg.group_of_row)
    np.testing.assert_array_equal(lay.lengths, rg.load)
    assert lay.jklm.shape == lay.ctl.shape == lay.vals.shape == (groups,
                                                                 rg.width)
    assert (lay.lengths % fused_rk4.CHUNK == 0).all()
    assert rg.width >= lay.lengths.max() + fused_rk4.CHUNK
    got = []
    for g, length in enumerate(lay.lengths):
        assert not lay.jklm[g, length:].any()
        assert not lay.ctl[g, length:].any()
        assert not lay.vals[g, length:].any()
        rows = lay.ctl[g, :length] & (fused_rk4.LAST - 1)
        last = (lay.ctl[g, :length] & fused_rk4.LAST) != 0
        # rows in increasing order, whole chunks, one LAST chunk a row
        assert (np.diff(rows) >= 0).all()
        assert (rows[::2] == rows[1::2]).all()
        assert (last[::2] == last[1::2]).all()
        assert set(rows) == set(np.flatnonzero(lay.group_of_row == g))
        assert last[::2].sum() == len(set(rows))
        ends = np.flatnonzero(last[::2]) * 2 + 1
        assert (np.diff(np.concatenate([rows[ends], [n]])) > 0).all()
        idx = k5.unpack(lay.jklm[g, :length])
        for e in np.flatnonzero(lay.vals[g, :length]):
            got.append((rows[e] + 1, *idx[:, e], lay.vals[g, e]))
        zero = lay.vals[g, :length] == 0
        assert not lay.jklm[g, :length][zero].any()
    c = np.asarray(t.coords)
    keep = (c[0] != 0) & (np.asarray(t.data) != 0)
    want = [(*c[:, e], t.data[e]) for e in np.flatnonzero(keep)]
    assert sorted(got) == sorted(map(tuple, want))


def test_quartic_layout_writes_rows_without_entries(models):
    """The random tensor's last row has no entry: it gets one chunk of
    zero entries, flagged LAST, so that the kernel writes it."""
    t = models["random"]
    lay = k5.quartic_layout(t.coords, t.data, t.shape, 8)
    i = t.shape[0] - 2
    g = lay.group_of_row[i]
    at = np.flatnonzero((lay.ctl[g] & (fused_rk4.LAST - 1)) == i)
    at = at[at < lay.lengths[g]]
    assert len(at) == fused_rk4.CHUNK
    assert (lay.ctl[g, at] & fused_rk4.LAST).all()
    assert not lay.vals[g, at].any() and not lay.jklm[g, at].any()


@pytest.mark.parametrize("groups", [8, 16])
@pytest.mark.parametrize("name", MODELS)
def test_twin_matches_the_tendency(models, name, groups):
    """``quartic_group_tendency`` through the layout against the plain
    rank-5 ``Tendency``: float64 within 1e-13 of the largest |value|,
    on 5 states."""
    t = models[name]
    f = _tendency(t)
    x = states(t.shape[0] - 1, 5, 4)
    lay = k5.quartic_layout(t.coords, t.data, t.shape, groups)
    ref = f(0., x)
    got = k5.quartic_group_tendency(lay, x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=F64_REL * ref.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_records_pack_the_layout(models, dtype):
    """``quartic_records``: 16 bytes a record, ``{jklm, ctl, value}``, the
    value in the kernel's dtype (float32 in the first value word)."""
    t = models["t4"]
    lay = k5.quartic_layout(t.coords, t.data, t.shape, 8)
    recs = k5.quartic_records(lay, dtype)
    assert recs.dtype == np.int32 and recs.shape == lay.jklm.shape + (4,)
    assert recs.nbytes == fused_rk4.REC_BYTES * lay.jklm.size
    np.testing.assert_array_equal(recs[..., 0], lay.jklm)
    np.testing.assert_array_equal(recs[..., 1], lay.ctl)
    if dtype == torch.float64:
        vals = np.ascontiguousarray(recs[..., 2:]).view("<f8")[..., 0]
        np.testing.assert_array_equal(vals, lay.vals)
    else:
        vals = np.ascontiguousarray(recs[..., 2]).view("<f4")
        np.testing.assert_array_equal(vals, lay.vals.astype(np.float32))
        assert not recs[..., 3].any()


def test_groups_rule(models):
    """G is K5's 16 for every rank-5 tensor, the route's and the
    launcher's plans both: 16 groups shorten T4's longest table from 744
    records to 430 (its 428-entry row and a chunk ahead) and dynamic-T's
    too."""
    assert k5.K5.groups == 16
    for name, widths in (("t4", (744, 430)), ("dynT", None)):
        t = models[name]
        w8, w16 = (fused_rk4.row_groups(t.coords, t.shape[0], g).width
                   for g in (8, 16))
        assert w16 < w8
        if widths:
            assert (w8, w16) == widths


@pytest.mark.parametrize("groups,width", [(8, 744), (16, 430)])
def test_t4_fits_the_h100(models, groups, width):
    """T4's layout (744 records a group at G = 8, 430 at 16) and the state
    rows of a block fit the H100's opt-in shared memory, in float64 and
    float32; the formula is the kernel's: records, then four rows of 32
    lanes (K1's resident formula: one resident kernel)."""
    t = models["t4"]
    assert fused_rk4.row_groups(t.coords, 39, groups).width == width
    for dtype, item in ((torch.float64, 8), (torch.float32, 4)):
        size = fused_rk4.smem_bytes(39, groups, width, dtype)
        assert size == 16 * groups * width + item * (2 * 38 + 2 * 39) * 32
        assert size <= H100_OPTIN
    with pytest.raises(TypeError):
        fused_rk4.smem_bytes(39, groups, width, torch.float16)


# -- the paired layout --------------------------------------------------------

def _needed_pairs(t):
    """The pairs the entries (output row 0 dropped) need, from their
    sorted trailing indices: a quartic entry's (j, k) and (l, m), a cubic
    one's (l, m)."""
    c = np.asarray(t.coords)
    s = np.sort(c[1:, c[0] != 0], axis=0)
    quartic = (s != 0).all(axis=0)
    cubic = (s != 0).sum(axis=0) == 3
    return {(int(a), int(b)) for a, b in np.concatenate(
        [s[:2, quartic], s[2:, quartic | cubic]], axis=1).T}


@pytest.mark.parametrize("name", MODELS)
def test_pair_table_holds_every_pair_once(models, name):
    """The pair table: each pair that an entry needs, both indices
    nonzero, once, in increasing order, and no other; 111 pairs for T4
    (all of them its quartic entries'), 20 for dynamic-T."""
    t = models[name]
    lay = k5.quartic_layout(t.coords, t.data, t.shape, 16)
    pairs = lay.pairs
    assert pairs.ndim == 2 and pairs.shape[1] == 2
    assert (pairs > 0).all() and (pairs[:, 0] <= pairs[:, 1]).all()
    keys = pairs[:, 0] * t.shape[0] + pairs[:, 1]
    assert (np.diff(keys) > 0).all()
    assert set(map(tuple, pairs.tolist())) == _needed_pairs(t)
    assert len(pairs) == k5.pair_count(t.coords, t.shape[0])
    assert len(pairs) == {"t4": 111, "dynT": 20}.get(name, len(pairs))


@pytest.mark.parametrize("name", MODELS)
def test_paired_indices_lie_in_the_extended_input(models, name):
    """Every paired record's two indices lie in ``[0, n1 + P)``; each
    entry's term over the extended input ``[1, y, p]`` is the product of
    its four trailing indices' values, exactly on integer-valued states;
    zero records have the indices 0."""
    t = models[name]
    n1 = t.shape[0]
    lay = k5.quartic_layout(t.coords, t.data, t.shape, 16)
    P = len(lay.pairs)
    a, b = lay.ab & 0xffff, lay.ab >> 16
    assert (a >= 0).all() and (b >= 0).all()
    assert (a < n1 + P).all() and (b < n1 + P).all()
    assert not lay.ab[lay.vals == 0].any()
    # values 2 .. n1 + 1 (xx[0] = 1): products of four of them are exact
    xx = np.arange(1, n1 + 1, dtype=np.float64)
    xx[1:] += 1
    xe = np.concatenate([xx, xx[lay.pairs[:, 0]] * xx[lay.pairs[:, 1]]])
    for g, length in enumerate(lay.lengths):
        idx = k5.unpack(lay.jklm[g, :length])
        np.testing.assert_array_equal(xe[a[g, :length]] * xe[b[g, :length]],
                                      np.prod(xx[idx], axis=0))


@pytest.mark.parametrize("groups", [8, 16])
@pytest.mark.parametrize("name", MODELS)
def test_paired_twin_matches_the_tendency(models, name, groups):
    """``paired_group_tendency`` through the paired tables against the
    plain rank-5 ``Tendency``: float64 within 1e-13 of the largest
    |value|, on 5 states."""
    t = models[name]
    f = _tendency(t)
    x = states(t.shape[0] - 1, 5, 4)
    lay = k5.quartic_layout(t.coords, t.data, t.shape, groups)
    ref = f(0., x)
    got = k5.paired_group_tendency(lay, x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=F64_REL * ref.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_paired_records_pack_the_layout(models, dtype):
    """``paired_records``: K1's 16-byte records ``{a | b << 16, ctl,
    value}`` with the four-gather layout's ``ctl`` and values, and the
    pair table as int32 words ``a | b << 16``; decoded by K1's
    ``streamed_tendency``'s reading over the extended input, they give
    the twin's tendency."""
    t = models["t4"]
    lay = k5.quartic_layout(t.coords, t.data, t.shape, 16)
    recs, words = k5.paired_records(lay, dtype)
    assert recs.dtype == np.int32 and recs.shape == lay.ab.shape + (4,)
    np.testing.assert_array_equal(recs[..., 0], lay.ab)
    np.testing.assert_array_equal(recs[..., 1:],
                                  k5.quartic_records(lay, dtype)[..., 1:])
    assert words.dtype == np.int32 and words.shape == (len(lay.pairs),)
    np.testing.assert_array_equal(words & 0xffff, lay.pairs[:, 0])
    np.testing.assert_array_equal(words >> 16, lay.pairs[:, 1])
    x = states(38, 5, 11, dtype)
    xx = torch.cat([torch.ones(5, 1, dtype=dtype), x], dim=1)
    p = xx[:, words & 0xffff] * xx[:, words >> 16]
    got = fused_rk4.streamed_tendency(recs, lay.lengths,
                                      torch.cat([x, p], dim=1))[:, :38]
    want = k5.paired_group_tendency(lay, x)
    assert torch.equal(got, want)


def test_paired_layout_fits_the_h100(models):
    """T4's paired layout at G = 16: the four-gather block's 149,504 B,
    each stage input 111 rows longer and the pair table, 206,780 B in
    float64 (158,652 B in float32), inside the H100's 232,448 B."""
    t = models["t4"]
    width = fused_rk4.row_groups(t.coords, 39, 16).width
    for dtype, item in ((torch.float64, 8), (torch.float32, 4)):
        size = k5.paired_smem_bytes(39, 111, 16, width, dtype)
        assert size == (fused_rk4.smem_bytes(39, 16, width, dtype)
                        + item * 2 * 111 * 32 + 4 * 111)
        assert size <= H100_OPTIN
    assert k5.paired_smem_bytes(39, 111, 16, width, torch.float64) == 206780


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", MODELS)
def test_rule_takes_the_paired_layout(models, name, dtype):
    """The launch plan's choice at the H100's limit: the paired layout
    wherever it fits, so for T4 (5,350 records, 111 pairs), dynamic-T (462
    records, 20 pairs) and the random tensor, in float64 and float32; the
    plan's bytes are the paired layout's, then the four-gather one's; its
    tables are ``paired_records``'."""
    t = models[name]
    f = _tendency(t, dtype)
    plan = fused_rk4.launch_plan(f, k5.K5, dtype, "cpu", limit=H100_OPTIN)
    records = {"t4": 5350, "dynT": 462}.get(name)
    assert records is None or int(plan.rows.load.sum()) == records
    width, n1 = plan.rows.width, t.shape[0]
    assert plan.sizes == (
        k5.paired_smem_bytes(n1, k5.pair_count(t.coords, n1), 16, width,
                             dtype),
        fused_rk4.smem_bytes(n1, 16, width, dtype))
    assert plan.kernel == "paired"
    kernel, (lengths, recs, words) = fused_rk4.plan_tables(
        f, k5.K5, None, dtype, "cpu", limit=H100_OPTIN)
    assert kernel == "paired"
    want, want_words = k5.paired_records(plan.layout, dtype)
    np.testing.assert_array_equal(recs.numpy(), want)
    np.testing.assert_array_equal(words.numpy(), want_words)
    np.testing.assert_array_equal(lengths.numpy(), plan.layout.lengths)


def test_rule_keeps_four_gathers_where_pairs_do_not_fit(models):
    """A limit between T4's four-gather block (149,504 B) and its paired
    one (206,780 B): the four-gather layout; below both, none."""
    f = _tendency(models["t4"])
    for limit, kernel in ((200_000, "resident"), (149_504, "resident"),
                          (149_503, None)):
        assert fused_rk4.launch_plan(f, k5.K5, torch.float64, "cpu",
                                     limit=limit).kernel == kernel


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_rule_keeps_four_gathers_on_dynamic_t_at_ndim_114(dyn_t_114, dtype):
    """The four-gather layout's own configuration: dynamic-T at ndim 114
    (58 pairs) in float64, its paired block 246,504 B past the H100's
    232,448 B and its four-gather one 216,576 B inside; in float32 (173,032
    and 157,952 B) the paired one."""
    t = dyn_t_114
    plan = fused_rk4.launch_plan(_tendency(t, dtype), k5.K5, dtype, "cpu",
                                 limit=H100_OPTIN)
    assert t.shape[0] == 115 and k5.pair_count(t.coords, 115) == 58
    assert (plan.sizes, plan.kernel) == {
        torch.float64: ((246504, 216576), "resident"),
        torch.float32: ((173032, 157952), "paired")}[dtype]


@pytest.mark.parametrize("groups", [8, 16])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_k5_launches_never_count_k1(models, monkeypatch, layout, groups):
    """K5's run over either layout at G = 8 or 16 (the launch itself
    stood in for: it has no CPU build) counts one launch in
    ``fused_rk4_quartic.launches``, one in ``launches_paired`` over the
    paired layout, and none of K1's; the paired launch passes its pair
    table and count after the records."""
    seen = []

    def stand_in(kernel, fn, tables, n1, y, dts, write_every, *extra):
        seen.append((kernel, fn, len(tables), extra))
        return y, y, 1

    monkeypatch.setattr(k5, "run_records", stand_in)
    t = models["t4"]
    f = _tendency(t)
    kernel, tables = fused_rk4.plan_tables(f, k5.K5, layout, torch.float64,
                                           "cpu", groups, H100_OPTIN)
    before = (k5.launches, k5.launches_paired, fused_rk4.launches,
              fused_rk4.launches_streamed)
    k5.K5.run(kernel, tables, 39, states(38, 2, 0), None, 0)
    after = (k5.launches, k5.launches_paired, fused_rk4.launches,
             fused_rk4.launches_streamed)
    assert np.subtract(after, before).tolist() == [
        1, int(layout == "paired"), 0, 0]
    (name, fn, n_tables, extra), = seen
    if layout == "paired":
        assert (name, fn, n_tables) == ("rk4_paired", "qgs_rk4_paired_f64",
                                        2)
        assert extra == (tables[2].data_ptr(), 111)
    else:
        assert (name, fn, n_tables, extra) == ("rk4_quartic",
                                               "qgs_rk4_quartic_f64", 2, ())


# -- the launch plan ----------------------------------------------------------

def test_k5_plan_is_built_once_a_key_beside_k1s(models, monkeypatch):
    """K5's plan of a rank-5 tendency, the four-gather layout forced by a
    paired layout of no size: one plan and one layout a key (the second
    tables' request a plan hit) at K5's G, the records of
    ``quartic_records``; K1's plan of the same module is another."""
    force_layout(monkeypatch, "resident")
    t = models["t4"]
    f = _tendency(t)
    builds, hits = k5.layout_builds, fused_rk4.plan_hits
    k1_builds = fused_rk4.layout_builds
    plan = fused_rk4.launch_plan(f, k5.K5, torch.float64, "cpu",
                                 limit=H100_OPTIN)
    assert plan.kernel == "resident" and plan.rows.width == 430
    assert plan.sizes == (None, fused_rk4.smem_bytes(39, 16, plan.rows.width,
                                                     torch.float64))
    got = [fused_rk4.plan_tables(f, k5.K5, None, torch.float64, "cpu",
                                 limit=H100_OPTIN)
           for _ in range(2)]
    assert fused_rk4.launch_plan(f, k5.K5, torch.float64,
                                 torch.device("cpu"), 16,
                                 limit=H100_OPTIN) is plan
    assert k5.layout_builds - builds == 1
    assert fused_rk4.layout_builds == k1_builds
    assert fused_rk4.plan_hits - hits == 1
    (k_a, (len_a, rec_a)), (k_b, (len_b, rec_b)) = got
    assert k_a == k_b == "resident" and rec_a is rec_b
    assert isinstance(plan.layout, k5.QuarticLayout)
    assert plan.layout.jklm.shape == (16, 430)
    np.testing.assert_array_equal(rec_a.numpy(), k5.quartic_records(
        plan.layout, torch.float64))
    np.testing.assert_array_equal(len_a.numpy(), plan.layout.lengths)
    k1 = fused_rk4.launch_plan(f, fused_rk4.K1, torch.float64, "cpu",
                               limit=H100_OPTIN)
    assert k1 is not plan and len(f.launch_plans) == 2


def test_k5_plan_without_room_is_none(models):
    """A limit below the layout: no kernel, and the tables' request raises
    K5's own error, naming the limit."""
    t = models["t4"]
    f = _tendency(t)
    plan = fused_rk4.launch_plan(f, k5.K5, torch.float64, "cpu",
                                 limit=100_000)
    assert plan.kernel is None
    with pytest.raises(RuntimeError, match="rk4_quartic.*does not fit the "
                                           "100000 B"):
        fused_rk4.plan_tables(f, k5.K5, None, torch.float64, "cpu",
                              limit=100_000)


class _OnCard:
    """A stand-in tensor that reports a CUDA device (the launcher's checks
    read no data)."""
    device = torch.device("cuda", 0)
    is_cuda = True

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), dtype

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def numel(self):
        return int(np.prod(self.shape))


def test_launcher_raises_on_the_cpu(models):
    t = models["t4"]
    with pytest.raises(ValueError, match="runs on CUDA"):
        k5.fused_rk4_quartic(_tendency(t), states(38, 2, 0),
                             torch.full((3,), 0.01, dtype=torch.float64))


def test_launcher_raises_past_8_bit_indices():
    t = random_rank5(1, n1=300, nnz=50)
    with pytest.raises(ValueError, match="n1 = 300 exceeds"):
        k5.fused_rk4_quartic(_tendency(t), _OnCard((2, 299), torch.float64),
                             _OnCard((3,), torch.float64))
    with pytest.raises(ValueError, match="8-bit"):
        k5.quartic_csr(t.coords, t.data, t.shape)


def test_launcher_raises_without_room(models, monkeypatch):
    """A card whose shared memory a block is below the layout: the launch
    plan has no kernel and the launcher raises before any upload."""
    monkeypatch.setattr(_build, "max_smem_optin", lambda device: 65536)
    t = models["t4"]
    with pytest.raises(RuntimeError, match="does not fit the 65536 B"):
        k5.fused_rk4_quartic(_tendency(t), _OnCard((2, 38), torch.float64),
                             _OnCard((3,), torch.float64))


def test_launcher_refuses_rank_3_and_other_dtypes(models):
    rank3 = COO(np.array([[1, 1], [1, 2], [0, 1]]), np.array([1., 2.]),
                (3, 3, 3))
    with pytest.raises(TypeError, match="rank-5"):
        k5.fused_rk4_quartic(_tendency(rank3), _OnCard((2, 2), torch.float64),
                             _OnCard((3,), torch.float64))
    with pytest.raises(TypeError, match="float32 or float64"):
        k5.fused_rk4_quartic(_tendency(models["t4"]),
                             _OnCard((2, 38), torch.float16),
                             _OnCard((3,), torch.float64))


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K5 has no CPU build")
    return torch.device("cuda", 0)


def _dts(n_steps, dt, device):
    return torch.full((n_steps,), dt, dtype=torch.float64, device=device)


def _plain(f, y, dts, write_every):
    """The plain step loop's RK4 steps (``make_rk_step``'s formula, K1's
    plain version) over the plain contraction."""
    return fused_rk4.fused_rk4_reference(f, y, dts, write_every)


DT = 0.01                # the T4 example's step


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", MODELS)
def test_kernel_matches_plain_loop_f64(models, cuda_device, name, layout,
                                       monkeypatch):
    """float64, B = 1000 (a ragged last block), 200 steps, a record every
    50: within 1e-12 of the largest |value| of the plain loop's."""
    force_layout(monkeypatch, layout)
    t = models[name]
    f = _tendency(t, torch.float64, cuda_device)
    y = states(t.shape[0] - 1, 1000, 1, device=cuda_device)
    dts = _dts(200, DT, cuda_device)
    got = k5.fused_rk4_quartic(f, y, dts, 50)
    ref = _plain(f, y, dts, 50)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        scale = b.abs().max().item()
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                                   atol=KERNEL_F64["rtol"] * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", MODELS)
def test_kernel_matches_plain_loop_f32(models, cuda_device, name, layout,
                                       monkeypatch):
    """float32 against the plain float32 loop, B = 1000, 200 steps: within
    1e-6 of the plain float64 loop's largest |value| (both round to
    float32 in other orders)."""
    force_layout(monkeypatch, layout)
    t = models[name]
    f32 = _tendency(t, torch.float32, cuda_device)
    y = states(t.shape[0] - 1, 1000, 2, device=cuda_device)
    dts = _dts(200, DT, cuda_device)
    got, _ = k5.fused_rk4_quartic(f32, y.float(), dts, 0)
    ref, _ = _plain(f32, y.float(), dts, 0)
    ref64, _ = _plain(_tendency(t, torch.float64, cuda_device), y, dts, 0)
    torch.cuda.synchronize()
    scale = ref64.abs().max().item()
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               ref.double().cpu().numpy(), rtol=0,
                               atol=KERNEL_F32["rtol"] * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("write_steps", [0, 1, 50])
def test_integrate_records_through_k5(models, cuda_device, write_steps):
    """``integrate_runge_kutta`` of T4 on the card takes K5 (one launch,
    over the paired layout, which the plan takes for T4; no K1, K2 or
    plain contraction) and gives the plain route's records (the same call
    on the CPU) within 1e-12, at write_steps 0, 1 and 50, over 101 steps
    with a shorter last one."""
    t = models["t4"]
    f = _tendency(t, torch.float64, cuda_device)
    ic = states(38, 40, 5)
    before = (k5.launches, k5.launches_paired, fused_rk4.launches,
              fused_rk4.launches_streamed, contraction.two_level_calls)
    tt, traj = integrate_runge_kutta(f, 0., 1.005, 0.01, ic=ic,
                                     write_steps=write_steps)
    torch.cuda.synchronize()
    after = (k5.launches, k5.launches_paired, fused_rk4.launches,
             fused_rk4.launches_streamed, contraction.two_level_calls)
    assert np.subtract(after, before).tolist() == [1, 1, 0, 0, 0]
    tc, ref = integrate_runge_kutta(_tendency(t), 0., 1.005, 0.01, ic=ic,
                                    write_steps=write_steps)
    np.testing.assert_array_equal(tt, tc)
    assert traj.shape == ref.shape and traj.device.type == "cuda"
    np.testing.assert_allclose(traj.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=1e-12 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("B", [33, 4097])
def test_ragged_batches(models, cuda_device, B, layout, monkeypatch):
    """B = 33 and 4097 (one live lane in the last block): each member's
    result equals the same member's in a launch of B = 1 bit for bit,
    and the plain loop's within 1e-12."""
    force_layout(monkeypatch, layout)
    t = models["t4"]
    f = _tendency(t, torch.float64, cuda_device)
    y = states(38, B, 6, device=cuda_device)
    dts = _dts(20, 0.01, cuda_device)
    got, rec = k5.fused_rk4_quartic(f, y, dts, 10)
    for b in (0, B - 1):
        one, one_rec = k5.fused_rk4_quartic(f, y[b:b + 1].contiguous(), dts,
                                            10)
        assert torch.equal(got[b], one[0]) and torch.equal(rec[:, b],
                                                           one_rec[:, 0])
    ref, _ = _plain(f, y, dts, 0)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=1e-12 * ref.abs().max().item())
    assert rec.shape == (2, B, 38)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_launch_counts_in_k5_alone(models, cuda_device, layout,
                                   monkeypatch):
    """A launch counts one in ``fused_rk4_quartic.launches`` (and one in
    ``launches_paired`` over the paired layout), and nothing in K1's
    counters (which the benchmark's path check reads) or in the plain
    contraction's."""
    force_layout(monkeypatch, layout)
    t = models["dynT"]
    f = _tendency(t, torch.float64, cuda_device)
    y = states(38, 64, 7, device=cuda_device)
    before = (k5.launches, k5.launches_paired, fused_rk4.launches,
              fused_rk4.launches_streamed, contraction.two_level_calls)
    for _ in range(3):
        k5.fused_rk4_quartic(f, y, _dts(5, 0.01, cuda_device), 0)
    torch.cuda.synchronize()
    after = (k5.launches, k5.launches_paired, fused_rk4.launches,
             fused_rk4.launches_streamed, contraction.two_level_calls)
    paired = 3 * (layout == "paired")
    assert np.subtract(after, before).tolist() == [3, paired, 0, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_stored_plan_launches_bit_equal(models, cuda_device, dtype, layout,
                                        monkeypatch):
    """The second launch of one module (its stored plan, a plan hit) is
    bit-equal to the first, and to a fresh module's."""
    force_layout(monkeypatch, layout)
    t = models["t4"]
    f = _tendency(t, dtype, cuda_device)
    y = states(38, 100, 8, dtype, cuda_device)
    dts = _dts(50, 0.01, cuda_device)
    first = k5.fused_rk4_quartic(f, y, dts, 7)
    hits = fused_rk4.plan_hits
    second = k5.fused_rk4_quartic(f, y, dts, 7)
    assert fused_rk4.plan_hits - hits == 1
    fresh = k5.fused_rk4_quartic(_tendency(t, dtype, cuda_device), y, dts, 7)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(torch.equal(a, b) for a, b in zip(first, fresh))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_both_group_counts_agree(models, cuda_device, layout, monkeypatch):
    """The layout at G = 8 (a plan's tables at 8, launched by K5's run)
    against K5's G = 16: the same rows summed in the same order, so
    bit-equal."""
    force_layout(monkeypatch, layout)
    t = models["t4"]
    f = _tendency(t, torch.float64, cuda_device)
    y = states(38, 100, 9, device=cuda_device)
    dts = _dts(30, 0.01, cuda_device)
    got16 = k5.fused_rk4_quartic(f, y, dts, 10)
    kernel, tables8 = fused_rk4.plan_tables(f, k5.K5, None, torch.float64,
                                            cuda_device, 8)
    assert kernel == layout
    got8 = k5.K5.run(kernel, tables8, t.shape[0], y, dts, 10)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got8, got16))


@pytest.mark.cuda
def test_four_gather_runs_dynamic_t_at_ndim_114(dyn_t_114, cuda_device):
    """Dynamic-T at ndim 114 in float64, where only the four-gather block
    fits: one K5 launch over it (none over the paired layout, none of
    K1's) within 1e-12 of the largest |value| of the plain loop (B = 100,
    50 steps, a record every 10)."""
    t = dyn_t_114
    f = _tendency(t, torch.float64, cuda_device)
    y = states(t.shape[0] - 1, 100, 12, device=cuda_device)
    dts = _dts(50, DT, cuda_device)
    before = (k5.launches, k5.launches_paired, fused_rk4.launches,
              fused_rk4.launches_streamed)
    got = k5.fused_rk4_quartic(f, y, dts, 10)
    after = (k5.launches, k5.launches_paired, fused_rk4.launches,
             fused_rk4.launches_streamed)
    assert np.subtract(after, before).tolist() == [1, 0, 0, 0]
    ref = _plain(f, y, dts, 10)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.isfinite(b).all()
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                                   atol=KERNEL_F64["rtol"]
                                   * b.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", MODELS)
def test_paired_kernel_matches_the_four_gather_one(models, cuda_device,
                                                   name, dtype):
    """Forced launches of both layouts on one state, 100 steps: within
    1e-12 (float64) or 1e-6 (float32) of the largest |value| of each
    other; they round the products in other orders."""
    t = models[name]
    f = _tendency(t, dtype, cuda_device)
    y = states(t.shape[0] - 1, 200, 10, dtype, cuda_device)
    dts = _dts(100, DT, cuda_device)
    four, paired = (k5.K5.launch(f, y, dts, 25, kernel=kernel)
                    for kernel in LAYOUTS)
    torch.cuda.synchronize()
    rtol = KERNEL_F64["rtol"] if dtype == torch.float64 else KERNEL_F32["rtol"]
    for a, b in zip(paired, four):
        np.testing.assert_allclose(
            a.double().cpu().numpy(), b.double().cpu().numpy(), rtol=0,
            atol=rtol * b.abs().max().item())

