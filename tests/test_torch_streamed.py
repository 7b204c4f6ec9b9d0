"""The streamed RK4 kernels: K1/K2 for tensors past one block's shared memory.

The resident kernels (K1 ``csrc/rk4_fused.cu``, K2 ``csrc/rk4_df_fused.cu``)
hold a tensor's records and the state in one block's shared memory.  The
streamed kernels (``csrc/rk4_streamed.cu``, ``csrc/rk4_df_streamed.cu``)
keep the records in device memory, streamed through a ring of tiles, and
only the two stage inputs on chip.  Checked here on the CPU:

* the Python twins of the streamed kernels' shared-memory formulas at
  MAOOAM ndim 36, 104 and 228 (the resolution sweep's settings) for
  float32, float64 and twofloat, and of K1's single-buffer variant (one
  stage input on chip) there and at ndim 600, against the H100's opt-in
  limit of 232,448 bytes passed explicitly, and the largest ndim each
  reaches;
* the choice between the resident and the streamed kernel and, for K1,
  the single-buffer variant (a launch plan's ``kernel``: ``resident``,
  ``streamed``, ``streamed_1buf`` or none, the plain step loop) for each
  precision at those widths and through a test's limit where only the
  variant fits, and the family ``fused_route`` returns on a stand-in card
  state;
* the records the streamed kernels read (``streamed_records`` /
  ``df_streamed_records``: ``group_layout``'s tables as 16-byte records,
  padded to whole ring tiles), evaluated by their plain twins
  (``streamed_tendency`` / ``df_streamed_tendency``) at ndim 104 and 228,
  bit for bit against ``group_tendency`` / ``df_group_tendency`` on the
  layout they pack, and against the port's ``Tendency`` / ``DfTendency``
  and the JAX package's ``create_tendencies`` ``f`` at rtol 1e-12 (only
  the summation order differs; twofloat keeps about 48 bits);
* the launchers refusing other dtypes and devices, and running the plain
  version on the CPU whichever kernel is asked for;
* the streamed K1's thread-block clusters: ``pick_cluster``'s choice of
  ``c`` from the sets of 32 members, the card's SMs and its clusters at
  each ``c``; the layout of ``c·G`` groups (each row in one group, block
  rank ``r`` of a cluster running groups ``r·G`` to ``r·G + G - 1``), its
  records evaluating the tendency bit for bit as the 8-group ones do; and
  the launch plan's ``c`` and tables, through a stand-in occupancy.

On the card (``cuda``-marked, skipped without one): the streamed kernels
forced where the resident ones run too, bit for bit equal to them at ndim
36 (B = 4097, a ragged last block) and 104; at ndim 228 against the plain
version; the clustered streamed K1 at every ``c`` bit for bit equal to
the launch without a cluster (ndim 228 at B = 1024, 1000 and 33, ndim 104
forced), with its counters, and ``c = 1`` at B = 4097; the single-buffer
variant forced at ndim 228 (B = 1000 x 23 steps, float64 and float32)
bit for bit equal to the two-buffer kernel, with its counters; and the
12x12 channel atmosphere (ndim 600, the benchmark's frozen tensor) on the
route's single-buffer variant against the plain reference.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from qgs_tpu.models.tendencies import create_tendencies as jax_create_tendencies
from qgs_tpu_torch.integrators.rk import fused_route, rk2_tableau, rk4_tableau
from qgs_tpu_torch.ops import _build, fused_df_rk4, fused_rk4
from qgs_tpu_torch.ops.contraction import Tendency
from qgs_tpu_torch.ops.twofloat import DfTendency, df_from_f64, df_to_f64

from tests.test_torch_host import both_params
from tests.test_torch_large_models import (H100_OPTIN, TOL32, TOL64, _OnCard,
                                           port_tendency, sweep, synthetic)

PRECISIONS = ("float64", "float32", "twofloat")

# ndim -> the streamed kernels' bytes at G = 8: float64, float32, twofloat
# (the rings' 16,384 plus two stage inputs of n1 rows of 32 lanes)
STREAMED_BYTES = {36: (35328, 25856, 35328), 104: (70144, 43264, 70144),
                  228: (133632, 75008, 133632)}
# ndim -> the kernel each precision launches on an H100
KERNEL = {36: ("resident", "resident", "resident"),
          104: ("resident", "resident", "streamed"),
          228: ("streamed", "streamed", "streamed")}
# ndim -> the single-buffer variant's bytes at G = 8: float64, float32
# (the rings' 16,384 plus one stage input of n1 rows of 32 lanes)
ONE_BUFFER_BYTES = {36: (25856, 21120), 104: (43264, 29824),
                    228: (75008, 45696), 600: (170240, 93312)}


def streamed_bytes(precision, n1, groups=8):
    if precision == "twofloat":
        return fused_df_rk4.df_streamed_smem_bytes(n1, groups)
    dtype = torch.float32 if precision == "float32" else torch.float64
    return fused_rk4.streamed_smem_bytes(n1, groups, dtype)


def plan(f, precision, limit=None):
    """The launch plan of ``f`` on a card in ``precision`` (the card's
    limit, or ``limit``)."""
    if precision == "twofloat":
        return fused_rk4.launch_plan(f, fused_df_rk4.DF, torch.float32,
                                     "cuda", limit=limit)
    dtype = torch.float32 if precision == "float32" else torch.float64
    return fused_rk4.launch_plan(f, fused_rk4.K1, dtype, "cuda", limit=limit)


def choose(f, precision, limit=None):
    return plan(f, precision, limit).kernel


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("ndim", [36, 104, 228])
def test_streamed_twins_give_the_launchers_bytes(ndim, precision):
    f = port_tendency("sweep", ndim)
    n1 = f.shape[0]
    want = STREAMED_BYTES[ndim][PRECISIONS.index(precision)]
    assert streamed_bytes(precision, n1) == want
    itemsize = 4 if precision == "float32" else 8
    assert want == fused_rk4.ring_bytes(8) + itemsize * 2 * n1 * 32
    assert fused_rk4.ring_bytes(8) == 8 * 4 * 32 * 16
    # the records do not count: only n1 does; the plan's streamed bytes are
    # the twin's, and its bound is inclusive
    assert plan(f, precision, H100_OPTIN).sizes[1] == want
    assert fused_rk4.pick_kernel((None, want), want) == "streamed"
    assert fused_rk4.pick_kernel((None, want), want - 1) is None


@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("ndim", [36, 104, 228, 600])
def test_one_buffer_twin_gives_the_launchers_bytes(ndim, precision):
    """K1's single-buffer variant keeps one stage input on chip: the
    rings and n1 rows of 32 lanes, the third of K1's layout sizes in a
    plan (twofloat's family has no such kernel)."""
    dtype = torch.float32 if precision == "float32" else torch.float64
    n1 = ndim + 1
    want = ONE_BUFFER_BYTES[ndim][precision == "float32"]
    assert fused_rk4.streamed_smem_bytes(n1, 8, dtype, inputs=1) == want
    assert want == (fused_rk4.ring_bytes(8)
                    + dtype.itemsize * n1 * fused_rk4.LANES)
    f = synthetic(n1) if ndim == 600 else port_tendency("sweep", ndim)
    assert plan(f, precision, H100_OPTIN).sizes[2] == want
    assert len(plan(f, "twofloat", H100_OPTIN).sizes) == 2


@pytest.mark.parametrize("precision, largest", [("float64", 421),
                                                ("float32", 843),
                                                ("twofloat", 421)])
def test_streamed_limit_on_the_h100(precision, largest):
    """The twins' bytes and the launch plans' choice at the streamed
    kernels' last width and one past it, on the H100: past it K1 takes its
    single-buffer variant, K2 none."""
    assert streamed_bytes(precision, largest + 1) <= H100_OPTIN
    assert streamed_bytes(precision, largest + 2) > H100_OPTIN
    assert choose(synthetic(largest + 1), precision, H100_OPTIN) == "streamed"
    past = None if precision == "twofloat" else "streamed_1buf"
    assert choose(synthetic(largest + 2), precision, H100_OPTIN) == past


@pytest.mark.parametrize("precision, largest", [("float64", 843),
                                                ("float32", 1687)])
def test_one_buffer_limit_on_the_h100(precision, largest):
    """The single-buffer variant's bytes and the plans' choice at its
    last width and one past it (none: the plain step loop)."""
    dtype = torch.float32 if precision == "float32" else torch.float64
    assert fused_rk4.streamed_smem_bytes(largest + 1, 8, dtype,
                                         inputs=1) <= H100_OPTIN
    assert fused_rk4.streamed_smem_bytes(largest + 2, 8, dtype,
                                         inputs=1) > H100_OPTIN
    assert choose(synthetic(largest + 1), precision,
                  H100_OPTIN) == "streamed_1buf"
    assert choose(synthetic(largest + 2), precision, H100_OPTIN) is None


@pytest.mark.parametrize("ndim", [36, 104, 228])
def test_kernel_choice(ndim, monkeypatch):
    """The launchers' choice on a card whose opt-in limit is the H100's
    (the limit passed, and read through a stand-in): the resident kernel
    where it fits, else the streamed one; ``fused_route`` takes a kernel
    for every precision up to ndim 228, and only for classical RK4."""
    monkeypatch.setattr(_build, "max_smem_optin", lambda device: H100_OPTIN)
    f = port_tendency("sweep", ndim)
    fdf = DfTendency(f.coords, f.data, f.shape, device="cpu")
    for precision, want in zip(PRECISIONS, KERNEL[ndim]):
        assert choose(f, precision, limit=H100_OPTIN) == want
        assert choose(f, precision) == want
        state = ((_OnCard(torch.float32),) * 2 if precision == "twofloat"
                 else _OnCard(torch.float32 if precision == "float32"
                              else torch.float64))
        g, family = ((fdf, fused_df_rk4.DF) if precision == "twofloat"
                     else (f, fused_rk4.K1))
        assert fused_route(g, state, rk4_tableau()) is family
        assert fused_route(g, state, rk2_tableau()) is None


def test_kernel_choice_past_the_streamed_limit(monkeypatch):
    """At n1 = 600 neither float64 kernel with two stage inputs fits the
    H100, so float64 takes K1's single-buffer variant; float32's two stage
    inputs still fit the streamed kernel; twofloat takes the plain step
    loop."""
    monkeypatch.setattr(_build, "max_smem_optin", lambda device: H100_OPTIN)
    f = synthetic(600)
    fdf = DfTendency(f.coords, f.data, f.shape, device="cpu")
    assert [choose(f, p) for p in PRECISIONS] == ["streamed_1buf",
                                                  "streamed", None]
    assert fused_route(f, _OnCard(torch.float64),
                       rk4_tableau()) is fused_rk4.K1
    assert fused_route(f, _OnCard(torch.float32),
                       rk4_tableau()) is fused_rk4.K1
    assert fused_route(fdf, (_OnCard(torch.float32),) * 2,
                       rk4_tableau()) is None


def test_plan_takes_the_one_buffer_variant_where_only_it_fits():
    """Through a limit between the variant's bytes and the two-buffer
    kernel's (ndim 228, float64 and float32) the plan takes the variant;
    its tables are the streamed kernel's records, built once and served
    as a plan hit after; it takes no cluster (the occupancy is not read),
    and a forced cluster raises.  One byte less and no kernel fits."""
    f = port_tendency("sweep", 228)
    occupancy = _Occupancy(H100_LIKE)
    k1 = fused_rk4.K1._replace(occupancy=occupancy)
    for dtype in (torch.float64, torch.float32):
        two = fused_rk4.streamed_smem_bytes(229, 8, dtype)
        one = fused_rk4.streamed_smem_bytes(229, 8, dtype, inputs=1)
        for limit in (one, two - 1):
            plan = fused_rk4.launch_plan(f, k1, dtype, "cpu", limit=limit)
            assert plan.kernel == "streamed_1buf"
            hits = fused_rk4.plan_hits
            for batch in (1024, 4096):
                kernel, tables = fused_rk4.plan_tables(
                    f, k1, None, dtype, "cpu", limit=limit, batch=batch)
                assert kernel == "streamed_1buf" and plan.cluster == 1
            assert fused_rk4.plan_hits - hits == 1
            lay = fused_rk4.group_layout(f.coords, f.data, f.shape, 8)
            assert torch.equal(tables[0], torch.as_tensor(lay.lengths))
            assert torch.equal(tables[1], torch.as_tensor(
                fused_rk4.streamed_records(lay, dtype)))
            with pytest.raises(ValueError, match="no cluster of 2"):
                fused_rk4.plan_tables(f, k1, None, dtype, "cpu",
                                      limit=limit, _cluster=2)
        assert fused_rk4.launch_plan(f, k1, dtype, "cpu",
                                     limit=one - 1).kernel is None
        with pytest.raises(RuntimeError, match="neither the resident.*"
                           "single-buffer"):
            fused_rk4.plan_tables(f, k1, None, dtype, "cpu", limit=one - 1)
    assert occupancy.calls == 0


_jax_f = {}


def jax_tendency(ndim):
    """The JAX package's batched float64 tendency of the sweep's MAOOAM."""
    if ndim not in _jax_f:
        jax_pars, _ = both_params(sweep(ndim))
        _jax_f[ndim] = jax_create_tendencies(jax_pars)[0].batched
    return _jax_f[ndim]


def states(ndim, B=6):
    return np.random.default_rng(ndim + B).random((B, ndim)) * 0.01


def check_records(recs, layout):
    """The packing: whole tiles, every walk's read-ahead inside them, the
    layout's indices and controls in the first two words, zeros past."""
    G, W = layout.jk.shape
    assert recs.dtype == np.int32 and recs.shape[:2] == (G, -(-W // 32) * 32)
    assert recs.shape[2] == 4 and recs.shape[1] % fused_rk4.TILE == 0
    tiles = -(-(layout.lengths + 2) // fused_rk4.TILE)
    assert (tiles * fused_rk4.TILE <= recs.shape[1]).all()
    assert np.array_equal(recs[:, :W, 0], layout.jk)
    assert np.array_equal(recs[:, :W, 1], layout.ctl)
    assert not recs[:, W:].any()
    for g, length in enumerate(layout.lengths):
        assert not recs[g, length:].any()


@pytest.mark.parametrize("ndim", [104, 228])
def test_streamed_records_evaluate_the_tendency(ndim):
    f = port_tendency("sweep", ndim)
    layout = fused_rk4.group_layout(f.coords, f.data, f.shape, 8)
    recs = fused_rk4.streamed_records(layout, torch.float64)
    check_records(recs, layout)
    x_np = states(ndim)
    x = torch.as_tensor(x_np)
    got = fused_rk4.streamed_tendency(recs, layout.lengths, x)
    assert torch.equal(got, fused_rk4.group_tendency(layout, x))
    ref = f(0., x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-14 * float(ref.abs().max()))
    jax_ref = np.asarray(jax_tendency(ndim)(0., x_np))
    np.testing.assert_allclose(got.numpy(), jax_ref, rtol=1e-12,
                               atol=1e-14 * float(np.abs(jax_ref).max()))
    # float32: the value's word decoded as the kernel decodes it
    recs32 = fused_rk4.streamed_records(layout, torch.float32)
    check_records(recs32, layout)
    assert not recs32[..., 3].any()
    x32 = x.float()
    got32 = fused_rk4.streamed_tendency(recs32, layout.lengths, x32)
    assert got32.dtype == torch.float32
    assert torch.equal(got32, fused_rk4.group_tendency(layout, x32))


@pytest.mark.parametrize("ndim", [104, 228])
def test_df_streamed_records_evaluate_the_tendency(ndim):
    f = port_tendency("sweep", ndim)
    fdf = DfTendency(f.coords, f.data, f.shape, device="cpu")
    layout = fused_rk4.group_layout(f.coords, f.data, f.shape, 8)
    recs = fused_df_rk4.df_streamed_records(layout)
    check_records(recs, layout)
    x_np = states(ndim)
    x = df_from_f64(torch.as_tensor(x_np))
    got = fused_df_rk4.df_streamed_tendency(recs, layout.lengths, *x)
    want = fused_df_rk4.df_group_tendency(layout, *x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got64 = df_to_f64(got).numpy()
    ref = df_to_f64(fdf(*x)).numpy()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got64, ref, rtol=1e-12, atol=1e-14 * scale)
    jax_ref = np.asarray(jax_tendency(ndim)(0., x_np))
    np.testing.assert_allclose(got64, jax_ref, rtol=1e-12,
                               atol=1e-14 * scale)


# SMs and clusters at c = 1 .. 8 of a card like the H100 at one block an
# SM (132 SMs in GPCs of 16 to 18), and of one whose GPCs hold fewer
H100_LIKE = (132, (132, 66, 44, 33, 26, 22, 18, 16))
FEWER_FOURS = (132, (132, 66, 42, 30, 24, 20, 14, 12))
THREE_AN_SM = (132, (396, 198, 124, 92, 69, 62, 47, 45))  # H100, f32, 228


@pytest.mark.parametrize("blocks, card, want", [
    (32, H100_LIKE, 4),                    # one wave of 32 clusters of 4
    (32, FEWER_FOURS, 3),                  # 30 of 4: two waves; 42 of 3
    (128, H100_LIKE, 1),                   # B = 4096: every c ties c = 1
    (129, H100_LIKE, 1),                   # B = 4097: the same
    (132, H100_LIKE, 1),                   # a block on every SM
    (200, (132, (132, 66, 44, 33, 26, 22, 18, 16)), 1),   # past the card
    (1, H100_LIKE, 8),                     # one set: the largest c
    (1, (132, (132, 66, 44, 33, 26, 22, 18, 0)), 7),      # 8 does not fit
    (32, (132, (396, 198, 132, 99, 79, 66, 56, 49)), 4),  # three an SM:
    # c = 8's 256 blocks put two on an SM, as slow as c = 4's one
    (32, (132, (0,) * 8), 1),              # no block fits: the launch refuses
    (32, THREE_AN_SM, 4),                  # float32 at ndim 228, B = 1024
    (64, THREE_AN_SM, 2),                  # B = 2048
    (128, THREE_AN_SM, 1),                 # B = 4096: c = 2 ties
    (131, THREE_AN_SM, 1),                 # B = 4192
    (1, THREE_AN_SM, 8),                   # one set
])
def test_pick_cluster(blocks, card, want):
    """``c`` is 1 where the sets fill the SMs, else the one of least time
    over ``c`` (the smaller on a tie): waves of clusters, a wave as long
    as its SM of the most blocks, each block ``1 / c`` of the entries."""
    assert fused_rk4.pick_cluster(blocks, *card) == want


def test_pick_cluster_counts_waves_where_a_block_has_an_sm():
    """Where a block has an SM to itself (float64 at ndim 228 on an H100)
    the rule is the fewest ``ceil(blocks / max_active[c - 1]) / c``."""
    sms, active = H100_F64 = (132, (132, 66, 39, 30, 22, 17, 15, 15))
    for blocks in range(1, sms):
        waves = [Fraction(-(-blocks // a), c) for c, a in enumerate(active, 1)]
        want = waves.index(min(waves)) + 1
        assert fused_rk4.pick_cluster(blocks, *H100_F64) == want, blocks


@pytest.mark.parametrize("ndim", [36, 228])
@pytest.mark.parametrize("cluster", [2, 3, 4, 8])
def test_cluster_layout_splits_the_rows(ndim, cluster):
    """The layout of ``c·G`` groups (block rank ``r`` of a cluster runs
    groups ``r·G`` to ``r·G + G - 1``): ``row_groups``' assignment, each
    row's records, ending in one last chunk, in exactly one group, every
    group's list in increasing rows."""
    f = port_tendency("sweep", ndim)
    G = fused_rk4.K1.groups
    lay = fused_rk4.group_layout(f.coords, f.data, f.shape, cluster * G)
    rows = fused_rk4.row_groups(f.coords, f.shape[0], cluster * G)
    np.testing.assert_array_equal(lay.group_of_row, rows.group_of_row)
    np.testing.assert_array_equal(lay.lengths, rows.load)
    seen = np.zeros(ndim, int)
    for g, length in enumerate(lay.lengths):
        ctl = lay.ctl[g, :length]
        row = ctl & (fused_rk4.LAST - 1)
        assert (np.diff(row) >= 0).all()
        assert (lay.group_of_row[row] == g).all()
        ends = row[1::2][(ctl[1::2] & fused_rk4.LAST) != 0]
        seen[ends] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("ndim", [36, 228])
def test_cluster_records_evaluate_like_eight_groups(ndim):
    """Each row is summed by one group over the same chunks in the same
    order at any G, so the records of 32 groups (c = 4) evaluate the
    tendency bit for bit as the 8 groups' do, in float64 and float32."""
    f = port_tendency("sweep", ndim)
    x = torch.as_tensor(states(ndim, 5))
    for dtype in (torch.float64, torch.float32):
        got = []
        for groups in (8, 32):
            lay = fused_rk4.group_layout(f.coords, f.data, f.shape, groups)
            got.append(fused_rk4.streamed_tendency(
                fused_rk4.streamed_records(lay, dtype), lay.lengths,
                x.to(dtype)))
        assert torch.equal(got[0], got[1])


class _Occupancy:
    """A stand-in for the card's occupancy query, counting its calls."""

    def __init__(self, card):
        self.card, self.calls = card, 0

    def __call__(self, n1, groups, dtype, device):
        self.calls += 1
        return self.card


def test_plan_picks_the_cluster_once_a_plan():
    """The streamed K1's plan reads the card's occupancy once and picks
    ``c`` for each launch's batch (``plan.cluster``, the last one's); a
    cluster's tables are those of the ``c·G``-group layout under
    ``("streamed", c)``, built once and then served as plan hits; the
    resident kernel, another family and another G take no cluster."""
    f = port_tendency("sweep", 228)
    occupancy = _Occupancy(H100_LIKE)
    k1 = fused_rk4.K1._replace(occupancy=occupancy)
    args = (torch.float64, "cpu")
    hits = fused_rk4.plan_hits
    for batch, want in ((1024, 4), (1000, 4), (4096, 1), (33, 8), (1024, 4)):
        kernel, tables = fused_rk4.plan_tables(f, k1, None, *args,
                                               limit=H100_OPTIN, batch=batch)
        plan = fused_rk4.launch_plan(f, k1, *args, limit=H100_OPTIN)
        assert plan.cluster == want
        assert kernel == ("streamed" if want == 1 else ("streamed", want))
        assert tables[0].shape[0] == want * 8
        lay = fused_rk4.group_layout(f.coords, f.data, f.shape, want * 8)
        assert torch.equal(tables[0], torch.as_tensor(lay.lengths))
        assert torch.equal(tables[1], torch.as_tensor(
            fused_rk4.streamed_records(lay, torch.float64)))
    assert occupancy.calls == 1
    assert fused_rk4.plan_hits - hits == 2
    assert set(plan.tables) == {("streamed", 4), "streamed", ("streamed", 8)}
    kernel, forced = fused_rk4.plan_tables(f, k1, None, *args,
                                           limit=H100_OPTIN, batch=1024,
                                           _cluster=2)
    assert kernel == ("streamed", 2)
    assert forced[0].shape[0] == 16 and plan.cluster == 2
    # 16 groups at G = 16 are one block's (which the launch refuses), not
    # a cluster of two: c comes from the plan, not the tables' shape
    kernel, tables = fused_rk4.plan_tables(f, k1, "streamed", *args,
                                           groups=16, limit=H100_OPTIN,
                                           batch=1024)
    assert kernel == "streamed" and tables[0].shape[0] == 16
    assert fused_rk4.plan_tables(f, k1, "resident", *args, limit=1 << 30,
                                 batch=1024)[1][0].shape[0] == 8
    with pytest.raises(ValueError, match="no cluster of 2"):
        fused_rk4.plan_tables(f, k1, "resident", *args, limit=1 << 30,
                              _cluster=2)
    for bad in (0, fused_rk4.MAX_CLUSTER + 1):
        with pytest.raises(ValueError, match=f"no cluster of {bad}"):
            fused_rk4.plan_tables(f, k1, "streamed", *args,
                                  limit=H100_OPTIN, _cluster=bad)
    with pytest.raises(ValueError, match="G = 4 takes no cluster"):
        fused_rk4.plan_tables(f, k1, "streamed", *args, groups=4,
                              limit=H100_OPTIN, _cluster=2)
    assert fused_rk4.plan_tables(f, k1, "streamed", *args, groups=4,
                                 limit=H100_OPTIN,
                                 batch=1024)[1][0].shape[0] == 4
    fdf = DfTendency(f.coords, f.data, f.shape, device="cpu")
    assert fused_rk4.plan_tables(fdf, fused_df_rk4.DF, None, torch.float32,
                                 "cpu", limit=H100_OPTIN,
                                 batch=1024)[1][0].shape[0] == 8
    assert occupancy.calls == 1


def test_launchers_refuse_other_dtypes_and_devices():
    f = port_tendency("sweep", 36)
    for call in (lambda: fused_rk4.streamed_smem_bytes(37, 8, torch.float16),
                 lambda: fused_rk4.smem_bytes(37, 8, 50, torch.float16),
                 lambda: fused_rk4.launch_plan(f, fused_rk4.K1, torch.float16,
                                               "cuda", limit=H100_OPTIN),
                 lambda: fused_rk4.streamed_records(
                     fused_rk4.group_layout(f.coords, f.data, f.shape, 8),
                     torch.float16)):
        with pytest.raises(TypeError, match="float32 or float64"):
            call()
    with pytest.raises(TypeError, match="float32"):
        fused_rk4.launch_plan(f, fused_df_rk4.DF, torch.float64, "cuda",
                              limit=H100_OPTIN)
    fdf = DfTendency(f.coords, f.data, f.shape, device="cpu")
    y = torch.zeros((2, 36), dtype=torch.float64, device="meta")
    dts = torch.full((3,), 0.1, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_rk4.fused_rk4(f, y, dts)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_df_rk4.fused_df_rk4(fdf, y.float(), y.float(), dts)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_rk4.K1.launch(f, y, dts, kernel="streamed")


def test_cpu_states_run_the_plain_version_whatever_the_kernel():
    """On the CPU the launchers run the plain version (the kernels have no
    CPU build), and count no launch of either kernel."""
    f = synthetic(600)
    fdf = DfTendency(f.coords, f.data, f.shape, device="cpu")
    y = torch.as_tensor(np.random.default_rng(3).random((3, 599)) * 0.01)
    dts = torch.full((4,), 0.1, dtype=torch.float64)
    before = (fused_rk4.launches, fused_rk4.launches_streamed,
              fused_rk4.launches_1buf, fused_df_rk4.launches,
              fused_df_rk4.launches_streamed)
    want, _ = fused_rk4.fused_rk4_reference(f, y, dts)
    want_df, _ = fused_df_rk4.fused_df_rk4_reference(fdf, *df_from_f64(y),
                                                     dts)
    runs = [(fused_rk4.fused_rk4(f, y, dts),
             fused_df_rk4.fused_df_rk4(fdf, *df_from_f64(y), dts))]
    runs += [(fused_rk4.K1.launch(f, y, dts, kernel=kernel),
              fused_df_rk4.DF.launch(fdf, df_from_f64(y), dts, kernel=kernel))
             for kernel in ("resident", "streamed", "streamed_1buf")]
    for (got, _), (got_df, _) in runs:
        assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(got_df, want_df))
    assert before == (fused_rk4.launches, fused_rk4.launches_streamed,
                      fused_rk4.launches_1buf, fused_df_rk4.launches,
                      fused_df_rk4.launches_streamed)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda", 0)


def run(f, precision, y, dts, kernel, write_every=7):
    """One launch of ``kernel`` (the launcher's choice where None); the
    final state and the records (a double-float state as its (hi, lo) parts
    stacked)."""
    if precision == "twofloat":
        fdf = DfTendency(f.coords, f.data, f.shape, device=y.device)
        got, recs = fused_df_rk4.DF.launch(fdf, df_from_f64(y), dts,
                                           write_every, kernel)
        return torch.stack(got), torch.stack(recs)
    if precision == "float32":
        f, y = Tendency(f.coords, f.data, f.shape, dtype=torch.float32,
                        device=y.device), y.float()
    return fused_rk4.K1.launch(f, y, dts, write_every, kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("ndim, precision, B", [
    (36, "float64", 4097), (36, "float32", 4097), (36, "twofloat", 4097),
    (104, "float64", 1000), (104, "float32", 1000)])
def test_streamed_equals_resident(cuda_device, ndim, precision, B):
    fc = port_tendency("sweep", ndim)
    f = Tendency(fc.coords, fc.data, fc.shape, device=cuda_device)
    y = torch.as_tensor(states(ndim, B), device=cuda_device)
    dts = torch.full((101,), 0.1, dtype=torch.float64, device=cuda_device)
    counts = fused_rk4.launches_streamed + fused_df_rk4.launches_streamed
    res = run(f, precision, y, dts, "resident")
    got = run(f, precision, y, dts, "streamed")
    torch.cuda.synchronize()
    assert (fused_rk4.launches_streamed + fused_df_rk4.launches_streamed
            == counts + 1)
    assert torch.equal(got[0], res[0]) and torch.equal(got[1], res[1])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", PRECISIONS)
def test_streamed_against_plain_at_ndim_228(cuda_device, precision):
    f_cpu = port_tendency("sweep", 228)
    f = Tendency(f_cpu.coords, f_cpu.data, f_cpu.shape, device=cuda_device)
    y = torch.as_tensor(states(228, 64), device=cuda_device)
    dts = torch.full((50,), 0.1, dtype=torch.float64, device=cuda_device)
    assert choose(f, precision) == "streamed"
    got, recs = run(f, precision, y, dts, None, write_every=10)
    ref, ref_recs = fused_rk4.fused_rk4_reference(f, y, dts, 10)
    if precision == "twofloat":
        got, recs = got[0].double() + got[1], recs[0].double() + recs[1]
    tol = TOL32 if precision == "float32" else TOL64
    torch.testing.assert_close(got.double(), ref, **tol)
    torch.testing.assert_close(recs.double(), ref_recs, **tol)
    with pytest.raises(TypeError):
        fused_rk4.fused_rk4(f, y.half(), dts)


def at_cluster(f, y, dts, write_every, cluster):
    """One launch of the streamed K1 as clusters of ``cluster`` blocks (its
    plan's tables at that ``c``)."""
    kernel, tables = fused_rk4.plan_tables(f, fused_rk4.K1, "streamed",
                                           y.dtype, y.device,
                                           _cluster=cluster)
    return fused_rk4.K1.run(kernel, tables, f.shape[0], y, dts, write_every)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("ndim, B", [(228, 1024), (228, 1000), (228, 33),
                                     (104, 1000), (228, 4097)])
def test_clustered_equals_one_block(cuda_device, ndim, B, precision):
    """The streamed K1 as clusters of every ``c`` from 2 to 8, bit for bit
    the launch without a cluster (final state and records; at ndim 104 the
    streamed kernel forced); a launch takes its plan's ``c``
    (``pick_cluster`` over the card's occupancy: 1 at B = 4097, 129 sets
    on 132 SMs), and every launch counts in
    ``launches_streamed``, those at ``c > 1`` in ``launches_clustered``."""
    fc = port_tendency("sweep", ndim)
    dtype = torch.float32 if precision == "float32" else torch.float64
    f = Tendency(fc.coords, fc.data, fc.shape, dtype=dtype,
                 device=cuda_device)
    y = torch.as_tensor(states(ndim, B), dtype=dtype, device=cuda_device)
    dts = torch.full((23,), 0.1, dtype=torch.float64, device=cuda_device)
    counts = (fused_rk4.launches_streamed, fused_rk4.launches_clustered)
    want = at_cluster(f, y, dts, 7, 1)
    for c in range(2, fused_rk4.MAX_CLUSTER + 1):
        got = at_cluster(f, y, dts, 7, c)
        assert torch.equal(got[0], want[0]), c
        assert torch.equal(got[1], want[1]), c
    got = fused_rk4.K1.launch(f, y, dts, 7, "streamed")
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    plan = fused_rk4.launch_plan(f, fused_rk4.K1, dtype, cuda_device)
    sms, active = plan.occupancy
    assert len(active) == fused_rk4.MAX_CLUSTER and active[0] >= 1
    assert plan.cluster == fused_rk4.pick_cluster(-(-B // 32), sms, active)
    if B == 4097:
        assert plan.cluster == 1
    launched = fused_rk4.MAX_CLUSTER + 1
    assert fused_rk4.launches_streamed - counts[0] == launched
    assert (fused_rk4.launches_clustered - counts[1]
            == launched - 2 + (plan.cluster > 1))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_one_buffer_equals_two_buffers(cuda_device, precision):
    """K1's single-buffer variant forced where the two-buffer streamed
    kernel runs too (ndim 228, B = 1000 x 23 steps): the final state and
    the records bit for bit equal; it counts in ``launches_streamed`` and
    in ``launches_1buf``, and takes no cluster."""
    fc = port_tendency("sweep", 228)
    dtype = torch.float32 if precision == "float32" else torch.float64
    f = Tendency(fc.coords, fc.data, fc.shape, dtype=dtype,
                 device=cuda_device)
    y = torch.as_tensor(states(228, 1000), dtype=dtype, device=cuda_device)
    dts = torch.full((23,), 0.1, dtype=torch.float64, device=cuda_device)
    want = at_cluster(f, y, dts, 7, 1)
    counts = (fused_rk4.launches_streamed, fused_rk4.launches_1buf,
              fused_rk4.launches_clustered)
    got = fused_rk4.K1.launch(f, y, dts, 7, "streamed_1buf")
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (fused_rk4.launches_streamed, fused_rk4.launches_1buf,
            fused_rk4.launches_clustered) == (counts[0] + 1, counts[1] + 1,
                                              counts[2])


@pytest.mark.cuda
def test_atmosphere_600_on_the_one_buffer_variant(cuda_device):
    """The 12x12 channel atmosphere (ndim 600, the benchmark's frozen
    tensor) integrated on the normal path, 8 members x 100 RK4 steps of dt
    0.005: one launch of the single-buffer variant, held against the
    plain float64 reference (``portbench/reference/qg.py``) at 1e-10 of
    each variable's largest value: the two sum each row in another order,
    and 100 steps grow that rounding far less than this."""
    from portbench.harness import checks, loader
    from portbench.reference import qg
    from qgs_tpu_torch.integrators.integrator import RungeKuttaIntegrator

    frozen = qg.load_tensor(loader.config("atm600"))
    f = Tendency(frozen.coords, frozen.data, frozen.shape,
                 device=cuda_device)
    assert choose(f, "float64") == "streamed_1buf"
    ic = np.random.default_rng(600).random((8, 600)) * 0.01
    counts = (fused_rk4.launches_streamed, fused_rk4.launches_1buf)
    integrator = RungeKuttaIntegrator()
    integrator.set_func(f)
    integrator.integrate(0., 0.5, 0.005, ic=ic, write_steps=10)
    _, traj = integrator.get_trajectories()
    torch.cuda.synchronize()
    assert (fused_rk4.launches_streamed - counts[0],
            fused_rk4.launches_1buf - counts[1]) == (1, 1)
    ref = qg.integrate(qg.Quadratic(frozen, torch.float64, cuda_device), ic,
                       0., 0.5, 0.005, 10)
    assert traj.shape == ref.shape == (8, 600, 11)
    assert checks.var_gap(traj, ref) <= 1e-10
