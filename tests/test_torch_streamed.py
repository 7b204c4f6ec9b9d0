"""The streamed RK4 kernels: K1/K2 for tensors past one block's shared memory.

The resident kernels (K1 ``csrc/rk4_fused.cu``, K2 ``csrc/rk4_df_fused.cu``)
hold a tensor's records and the state in one block's shared memory.  The
streamed kernels (``csrc/rk4_streamed.cu``, ``csrc/rk4_df_streamed.cu``)
keep the records in device memory, streamed through a ring of tiles, and
only the two stage inputs on chip.  Checked here on the CPU:

* the Python twins of the streamed kernels' shared-memory formulas at
  MAOOAM ndim 36, 104 and 228 (the resolution sweep's settings) for
  float32, float64 and twofloat, against the H100's opt-in limit of
  232,448 bytes passed explicitly, and the largest ndim each reaches;
* the choice between the resident and the streamed kernel (a launch
  plan's ``kernel``: ``resident``, ``streamed`` or neither, the plain step
  loop) for each precision at those widths, and the family ``fused_route``
  returns on a stand-in card state;
* the records the streamed kernels read (``streamed_records`` /
  ``df_streamed_records``: ``group_layout``'s tables as 16-byte records,
  padded to whole ring tiles), evaluated by their plain twins
  (``streamed_tendency`` / ``df_streamed_tendency``) at ndim 104 and 228,
  bit for bit against ``group_tendency`` / ``df_group_tendency`` on the
  layout they pack, and against the port's ``Tendency`` / ``DfTendency``
  and the JAX package's ``create_tendencies`` ``f`` at rtol 1e-12 (only
  the summation order differs; twofloat keeps about 48 bits);
* the launchers refusing other dtypes and devices, and running the plain
  version on the CPU whichever kernel is asked for.

On the card (``cuda``-marked, skipped without one): the streamed kernels
forced where the resident ones run too, bit for bit equal to them at ndim
36 (B = 4097, a ragged last block) and 104; and at ndim 228 against the
plain version.
"""

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


@pytest.mark.parametrize("precision, largest", [("float64", 421),
                                                ("float32", 843),
                                                ("twofloat", 421)])
def test_streamed_limit_on_the_h100(precision, largest):
    """The twins' bytes and the launch plans' choice at the streamed
    kernels' last width and one past it, on the H100."""
    assert streamed_bytes(precision, largest + 1) <= H100_OPTIN
    assert streamed_bytes(precision, largest + 2) > H100_OPTIN
    assert choose(synthetic(largest + 1), precision, H100_OPTIN) == "streamed"
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
    """At n1 = 600 neither float64 kernel fits the H100 (the plain step
    loop runs), while float32's stage inputs still fit the streamed one."""
    monkeypatch.setattr(_build, "max_smem_optin", lambda device: H100_OPTIN)
    f = synthetic(600)
    fdf = DfTendency(f.coords, f.data, f.shape, device="cpu")
    assert [choose(f, p) for p in PRECISIONS] == [None, "streamed", None]
    assert fused_route(f, _OnCard(torch.float64), rk4_tableau()) is None
    assert fused_route(f, _OnCard(torch.float32),
                       rk4_tableau()) is fused_rk4.K1
    assert fused_route(fdf, (_OnCard(torch.float32),) * 2,
                       rk4_tableau()) is None


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
              fused_df_rk4.launches, fused_df_rk4.launches_streamed)
    want, _ = fused_rk4.fused_rk4_reference(f, y, dts)
    want_df, _ = fused_df_rk4.fused_df_rk4_reference(fdf, *df_from_f64(y),
                                                     dts)
    runs = [(fused_rk4.fused_rk4(f, y, dts),
             fused_df_rk4.fused_df_rk4(fdf, *df_from_f64(y), dts))]
    runs += [(fused_rk4.K1.launch(f, y, dts, kernel=kernel),
              fused_df_rk4.DF.launch(fdf, df_from_f64(y), dts, kernel=kernel))
             for kernel in ("resident", "streamed")]
    for (got, _), (got_df, _) in runs:
        assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(got_df, want_df))
    assert before == (fused_rk4.launches, fused_rk4.launches_streamed,
                      fused_df_rk4.launches, fused_df_rk4.launches_streamed)


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
