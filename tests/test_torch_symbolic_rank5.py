"""The port's symbolic rank-5 tensors (``SymbolicQgsTensorDynamicT`` and
``SymbolicQgsTensorT4`` of ``qgs_tpu_torch.tensors.symbolic_qgtensor``,
copies of the JAX package's) against the JAX package's, on a 1x1 symbolic
channel coupled to a 1x2 symbolic basin (ndim 12; the smallest
configuration both packages build: without an ocean the dynamic-T tensor
raises in both, ROADMAP §3): ``tensor_dict`` and ``jac_dic`` key for key,
with SymPy ``==`` on the values, as ``tests/test_torch_symbolic.py`` does
for RP; and the port's ``sub_tensor()`` against its numeric
``QgsTensorDynamicT`` / ``QgsTensorT4`` on the same basis (inner products
by quadrature), rtol 1e-12.

Two faults of the JAX package are repaired in the port (ROADMAP §3):
its ``ScalingParameter.__neg__`` drops the sign of the symbolic expression
(``qgs_tpu/params/parameter.py:191-192``), so the symbolic
``G = -L^2/LR^2`` enters the oceanic streamfunction rows with the wrong
sign; and its exact oceanic inner products leave out the quartic ``_V``
of the rank-5 schemes (``qgs_tpu/inner_products/symbolic.py:668-702``),
so the oceanic temperature rows lose their own radiation.  The JAX
package's tensors are built here with the repairs applied in this process
(the port's ``__neg__``, and the port's exact ``_V``, SymPy expressions
that either package's assembly reads), so that the two copies of the
tensor assembly are compared on the same inputs.

Each package's exact SymPy inner products of the T4 scheme are computed
once (some 3-4 min of SymPy a package on one core, spread over a pool of
``POOL`` processes), with the aspect ratio ``n`` left free, as ``create_symbolic_tendencies`` computes them without continuation
variables.  The dynamic-T inner products are the T4 set restricted to the
pattern (i, 0, 0, 0, m) and its permutations (``_theta_pairs`` in both
packages computes the same integrals for those entries), so the dynamic-T
tensors are built from that restriction; the restriction is held against
the dynamic-T quadrature inner products on the port."""

import copy
import itertools

import pytest
import sympy

from qgs_tpu.inner_products import symbolic as jax_ips
from qgs_tpu.params import parameter as jax_parameter
from qgs_tpu.params.params import QgParams as JaxQgParams
from qgs_tpu.tensors import symbolic_qgtensor as jax_sqt
from qgs_tpu_torch.inner_products import symbolic as port_ips
from qgs_tpu_torch.params import parameter as port_parameter
from qgs_tpu_torch.params.params import QgParams as PortQgParams
from qgs_tpu_torch.tensors import qgtensor as port_qgtensor
from qgs_tpu_torch.tensors import symbolic_qgtensor as port_sqt
from qgs_tpu_torch.utils.sparse import COO

SCHEMES = {"dynamic_T": "QgsTensorDynamicT", "T4": "QgsTensorT4"}
QUARTIC = {"atm": ("_z", "_v"), "ocean": ("_Z", "_V")}
RTOL = 1e-12
POOL = 3        # worker processes of the exact integration


def channel_basin(QgParams, scheme=None):
    """The 1x1 symbolic channel and 1x2 symbolic basin with the rank-5
    radiation ``scheme`` (``'T4'`` or ``'dynamic_T'``; None for rank 3)."""
    pars = QgParams({'rr': 287., 'sb': 5.6e-8},
                    **({scheme: True} if scheme else {}))
    pars.set_atmospheric_channel_fourier_modes(1, 1, mode='symbolic')
    pars.set_oceanic_basin_fourier_modes(1, 2, mode='symbolic')
    return pars


def _dynamic_t_pattern(idx):
    """Whether the trailing indices of a quartic entry are a permutation of
    (0, 0, 0, m)."""
    return sum(i == 0 for i in idx[1:]) >= 3


def _restrict(arr):
    """A quartic inner-product array restricted to the dynamic-T pattern,
    in its own type (a SymPy sparse array or a COO)."""
    if arr is None:
        return None
    if isinstance(arr, COO):
        keep = [e for e in range(arr.nnz)
                if _dynamic_t_pattern(arr.coords[:, e])]
        return COO(arr.coords[:, keep], arr.data[keep], arr.shape)
    entries = {idx: v for idx in itertools.product(*map(range, arr.shape))
               if _dynamic_t_pattern(idx) and (v := arr[idx]) != 0}
    return type(arr)(entries, shape=arr.shape)


def dynamic_t_ips(aip, oip):
    """Copies of T4 inner products restricted to the dynamic-T pattern,
    the atmosphere's connected to the ocean copy."""
    aip_d, oip_d = copy.copy(aip), copy.copy(oip)
    for ip, names in ((aip_d, QUARTIC["atm"]), (oip_d, QUARTIC["ocean"])):
        for name in names:
            setattr(ip, name, _restrict(getattr(ip, name)))
        ip._T4, ip._dynamic_T = False, True
    return aip_d, oip_d


def _exact_ips(ips, pars):
    """Exact SymPy inner products, ``n`` left free, integrated by the
    package's own process pool (``num_threads``)."""
    kw = dict(return_symbolic=True, make_substitution=False,
              quadrature=False, num_threads=POOL)
    aip = ips.AtmosphericSymbolicInnerProducts(pars, **kw)
    oip = ips.OceanicSymbolicInnerProducts(pars, **kw)
    aip.connect_to_ocean(oip)
    return aip, oip


@pytest.fixture(scope="module")
def tensors():
    """Both packages' symbolic dynamic-T and T4 tensors, each package's
    exact T4 inner products computed once (the JAX package's oceanic
    quartic taken from the port's)."""
    out = {}
    for pkg, ips, sqt, QgParams in (
            ("port", port_ips, port_sqt, PortQgParams),
            ("jax", jax_ips, jax_sqt, JaxQgParams)):
        t4_ips = _exact_ips(ips, channel_basin(QgParams, "T4"))
        out[pkg, "V"] = t4_ips[1]._V
        if pkg == "jax":
            t4_ips[1]._V = out["port", "V"]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_parameter.ScalingParameter, "__neg__",
                       port_parameter.ScalingParameter.__neg__)
            for scheme, cls in SCHEMES.items():
                pars = channel_basin(QgParams, scheme)
                scheme_ips = (t4_ips if scheme == "T4"
                              else dynamic_t_ips(*t4_ips))
                out[pkg, scheme] = getattr(sqt, "Symbolic" + cls)(
                    pars, *scheme_ips)
    return out


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_symbolic_rank5_dicts_equal(tensors, scheme):
    jax_t, port_t = tensors["jax", scheme], tensors["port", scheme]
    assert type(port_t).__module__ == \
        "qgs_tpu_torch.tensors.symbolic_qgtensor"
    for name in ("tensor_dict", "jac_dic"):
        a, b = getattr(jax_t, name), getattr(port_t, name)
        assert len(a) > 0 and list(b) == list(a), name
        assert all(sympy.sympify(b[k]) == sympy.sympify(a[k]) for k in a), \
            name


def test_exact_ocean_ips_have_the_quartic(tensors):
    """The port's exact oceanic inner products carry the quartic ``_V`` of
    the rank-5 schemes (its values are held by
    ``test_sub_tensor_matches_the_numeric_tensor``)."""
    v = tensors["port", "V"]
    assert v is not None and len(v.tolist()) > 0
    assert any(x != 0 for x in sympy.flatten(v.tolist()))


def test_the_schemes_differ(tensors):
    """The dynamic-T tensor keeps fewer quartic entries than T4."""
    dyn = tensors["port", "dynamic_T"].tensor_dict
    t4 = tensors["port", "T4"].tensor_dict
    assert set(dyn) < set(t4)


def _canonical(items, fixed):
    """Entries summed over the permutations of their indices after the
    first ``fixed``: {(fixed indices, sorted rest): value}."""
    out = {}
    for idx, v in items:
        idx = tuple(int(i) for i in idx)
        key = idx[:fixed] + tuple(sorted(idx[fixed:]))
        out[key] = out.get(key, 0.) + float(v)
    return {k: v for k, v in out.items() if v != 0.}


def _numeric_tensor(scheme):
    """The port's numeric tensor of the configuration (rank 3 for
    ``scheme=None``), its inner products by quadrature."""
    pars = channel_basin(PortQgParams, scheme)
    aip = port_ips.AtmosphericSymbolicInnerProducts(pars)
    oip = port_ips.OceanicSymbolicInnerProducts(pars)
    aip.connect_to_ocean(oip)
    cls = SCHEMES[scheme] if scheme else "QgsTensor"
    return getattr(port_qgtensor, cls)(pars, aip, oip), aip, oip


def _coo_items(coo):
    return ((coo.coords[:, e], coo.data[e]) for e in range(coo.nnz))


def _assert_sub_tensor_matches(sym, num, label):
    """``sym.sub_tensor()`` entry for entry (summed over the permutations of
    the trailing indices) against the numeric tensor ``num``, rtol 1e-12
    (atol 1e-12 x the largest entry); the Jacobian likewise, its first two
    indices fixed."""
    for dic, coo, fixed in ((sym.tensor_dict, num.tensor, 1),
                            (sym.jac_dic, num.jacobian_tensor, 2)):
        got = _canonical(sym.sub_tensor(dic).items(), fixed)
        ref = _canonical(_coo_items(coo), fixed)
        scale = max(abs(v) for v in ref.values())
        for k in set(got) | set(ref):
            assert got.get(k, 0.) == pytest.approx(
                ref.get(k, 0.), rel=RTOL, abs=RTOL * scale), (k, label)


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_sub_tensor_matches_the_numeric_tensor(tensors, scheme):
    """The port's symbolic rank-5 tensor, every parameter substituted,
    against its numeric tensor on the same basis."""
    num, _, _ = _numeric_tensor(scheme)
    _assert_sub_tensor_matches(tensors["port", scheme], num, scheme)


def test_ocean_rows_keep_the_sign_of_g():
    """``G = -L^2/LR^2`` keeps its sign through the symbolic expression, so
    the rank-3 symbolic tensor of the channel and basin (inner products by
    quadrature) matches the numeric one on the oceanic streamfunction rows
    too."""
    pars = channel_basin(PortQgParams)
    subs = port_sqt.collect_parameter_substitutions(pars)
    g = sympy.sympify(pars.G.symbolic_expression).subs(subs)
    assert float(g) == pytest.approx(float(pars.G), rel=RTOL)
    assert float(pars.G) < 0
    num, aip, oip = _numeric_tensor(None)
    sym = port_sqt.SymbolicQgsTensor(pars, aip, oip)
    _assert_sub_tensor_matches(sym, num, "rank 3")


def test_dynamic_t_restriction_matches_its_inner_products():
    """The T4 quadrature inner products restricted to the dynamic-T pattern
    equal the dynamic-T quadrature inner products."""
    _, aip_t4, oip_t4 = _numeric_tensor("T4")
    _, aip_dyn, oip_dyn = _numeric_tensor("dynamic_T")
    restricted = dynamic_t_ips(aip_t4, oip_t4)
    for got_ip, ref_ip, names in ((restricted[0], aip_dyn, QUARTIC["atm"]),
                                  (restricted[1], oip_dyn,
                                   QUARTIC["ocean"])):
        for name in names:
            got, ref = getattr(got_ip, name), getattr(ref_ip, name)
            assert (got is None) == (ref is None), name
            if ref is None:
                continue
            assert ref.nnz > 0, name
            got_d = _canonical(_coo_items(got), 1)
            ref_d = _canonical(_coo_items(ref), 1)
            assert set(got_d) == set(ref_d), name
            for k, v in ref_d.items():
                assert got_d[k] == pytest.approx(v, rel=RTOL), (name, k)
