"""The port's symbolic export (``qgs_tpu_torch.functions.symbolic_tendencies``,
``.symbolic_mul`` and ``qgs_tpu_torch.tensors.symbolic_qgtensor``, copies
of the JAX package's) against the JAX package's, on the RP 2x2 symbolic
configuration of ``tests/test_symbolic_export.py:16-22``: the symbolic
tensor's ``tensor_dict`` and ``jac_dic`` key for key (SymPy ``==`` on the
values), the exported right-hand side and Jacobian strings character for
character in every language, without and with a continuation variable,
and the python export ``exec``'d against the port's ``f``/``Df`` on the
CPU (rtol 1e-8, atol 1e-10, as ``tests/test_symbolic_export.py:44``).

Each package's export costs about 15 s of SymPy a set of continuation
variables (most of it substituting the parameters), so each package runs
``create_symbolic_tendencies`` once a set, in python, and the other
languages are emitted from the same equations by that package's own
``equation_as_function`` and ``jacobian_as_function``."""

import math

import numpy as np
import pytest
import sympy
import torch

from qgs_tpu.functions import symbolic_mul as jax_mul
from qgs_tpu.functions import symbolic_tendencies as jax_sym
from qgs_tpu.params.params import QgParams as JaxQgParams
from qgs_tpu.tensors.symbolic_qgtensor import SymbolicQgsTensor as JaxSQT
from qgs_tpu_torch.functions import symbolic_mul as port_mul
from qgs_tpu_torch.functions import symbolic_tendencies as port_sym
from qgs_tpu_torch.models.tendencies import create_tendencies
from qgs_tpu_torch.params.params import QgParams as PortQgParams
from qgs_tpu_torch.tensors.symbolic_qgtensor import SymbolicQgsTensor as PortSQT

LANGUAGES = ("python", "julia", "fortran", "auto", "mathematica")
TOL = dict(rtol=1e-8, atol=1e-10)


def rp_symbolic(QgParams):
    """``tests/test_symbolic_export.py:16-22``: the RP channel on a
    symbolic basis (ndim 20)."""
    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
    pars.set_atmospheric_channel_fourier_modes(2, 2, mode='symbolic')
    pars.ground_params.set_orography(0.2, 1)
    pars.atemperature_params.set_thetas(0.2, 0)
    return pars


def _continuation(pars, name):
    return [] if name == "none" else [pars.atmospheric_params.kd]


def _export(sym, pars, cvs, ips):
    """One ``create_symbolic_tendencies`` call in python with the Jacobian;
    returns its strings, inner products, symbolic tensor, and the RHS and
    Jacobian equations it emitted them from."""
    seen = {}
    real = sym.jacobian_as_function

    def capture(equations, *args, **kwargs):
        seen["jac"] = equations
        return real(equations, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sym, "jacobian_as_function", capture)
        f_str, jac_str, ips, eq, tensor = sym.create_symbolic_tendencies(
            pars, cvs, *ips, language="python", return_jacobian=True,
            return_inner_products=True, return_symbolic_eqs=True,
            return_symbolic_qgtensor=True)
    return dict(f=f_str, jac=jac_str, ips=ips, tensor=tensor, eq=eq,
                jac_eq=seen["jac"])


@pytest.fixture(scope="module")
def exports():
    """Both packages' exports without and with the continuation variable
    ``kd``, each package's inner products computed once."""
    out = {}
    for pkg, sym, QgParams in (("jax", jax_sym, JaxQgParams),
                               ("port", port_sym, PortQgParams)):
        pars = rp_symbolic(QgParams)
        ips = (None, None, None)
        for cv in ("none", "kd"):
            out[pkg, cv] = _export(sym, pars, _continuation(pars, cv), ips)
            out[pkg, cv]["pars"] = pars
            ips = out[pkg, cv]["ips"]
    return out


def test_symbolic_tensor_dicts_equal(exports):
    jax_t, port_t = exports["jax", "none"]["tensor"], \
        exports["port", "none"]["tensor"]
    assert type(port_t).__module__ == "qgs_tpu_torch.tensors.symbolic_qgtensor"
    for name in ("tensor_dict", "jac_dic"):
        a, b = getattr(jax_t, name), getattr(port_t, name)
        assert len(a) > 0 and list(b) == list(a), name
        assert all(sympy.sympify(b[k]) == sympy.sympify(a[k]) for k in a), name


def _emit(sym, ex, cv, language):
    """The RHS and Jacobian strings in ``language``, or the error each
    raises (AUTO needs a continuation variable; Mathematica has no
    Jacobian emitter)."""
    pars = ex["pars"]
    cvs = _continuation(pars, cv)
    out = []
    for emit, eqs in ((sym.equation_as_function, ex["eq"]),
                      (sym.jacobian_as_function, ex["jac_eq"])):
        try:
            out.append(emit(eqs, pars, cvs, language))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


@pytest.mark.parametrize("cv", ["none", "kd"])
@pytest.mark.parametrize("language", LANGUAGES)
def test_exported_strings_equal(exports, language, cv):
    jax_ex, port_ex = exports["jax", cv], exports["port", cv]
    if language == "python":
        got = [port_ex["f"], port_ex["jac"]]
        ref = [jax_ex["f"], jax_ex["jac"]]
    else:
        got = _emit(port_sym, port_ex, cv, language)
        ref = _emit(jax_sym, jax_ex, cv, language)
    assert got == ref
    # the RHS is emitted in every language but AUTO without a variable
    f_out = got[0]
    assert not isinstance(f_out, tuple) or (language == "auto"
                                            and cv == "none")
    if cv == "kd" and language != "mathematica":
        assert "k_d" in str(f_out)


def _exec_generated(func_str):
    ns = {'np': np, 'math': math}
    exec(func_str, ns)
    return ns['f'] if 'f' in ns else ns['jac']


@pytest.mark.parametrize("cv", ["none", "kd"])
def test_python_export_matches_port(exports, cv):
    """The exported python RHS and Jacobian against the port's ``f`` and
    ``Df`` (on the CPU) on 16 states; with ``kd`` free, evaluated at its
    value."""
    ex = exports["port", cv]
    pars = ex["pars"]
    extra = [float(v) for v in _continuation(pars, cv)]
    f_gen, jac_gen = _exec_generated(ex["f"]), _exec_generated(ex["jac"])
    f, Df = create_tendencies(pars, device="cpu")
    xs = np.random.default_rng(0).random((16, pars.ndim)) * 0.2
    fx = f.batched(0., torch.as_tensor(xs)).numpy()
    jx = Df.batched(0., torch.as_tensor(xs)).numpy()
    for x, fx_i, jx_i in zip(xs, fx, jx):
        np.testing.assert_allclose(f_gen(0., x, *extra), fx_i, **TOL)
        np.testing.assert_allclose(jac_gen(0., x, *extra), jx_i, **TOL)


def test_dict_helpers_and_symbolic_products_equal():
    """The symbolic tensor's static dict helpers and the symbolic sparse
    products, on small dicts of symbols, against the JAX package's."""
    a, b, c, d = (sympy.symbols(f"{s}0:3") for s in "abcd")
    t3 = {(1, 0, 2): 2 * a[0], (1, 2, 0): 3 * b[1], (2, 1, 1): c[2] - c[2],
          (0, 1, 2): sympy.Rational(1, 3)}
    t5 = {(1, 0, 2, 1, 0): a[1], (2, 1, 1, 2, 0): -b[0], (1, 2, 1, 0, 0): 5}
    for helper in ("remove_dic_zeros", "simplify_dict", "jacobian_from_dict"):
        assert getattr(PortSQT, helper)(t3) == getattr(JaxSQT, helper)(t3)
        assert getattr(PortSQT, helper)(t5) == getattr(JaxSQT, helper)(t5)
    cases = [("symbolic_sparse_mult2", t3, (a,)),
             ("symbolic_sparse_mult3", t3, (a, b)),
             ("symbolic_sparse_mult4", t5, (a, b, c)),
             ("symbolic_sparse_mult5", t5, (a, b, c, d))]
    for name, tensor, vecs in cases:
        got = getattr(port_mul, name)(tensor, *vecs)
        assert got and got == getattr(jax_mul, name)(tensor, *vecs), name
    row = [a[0], 0, b[1]]
    assert port_mul.symbolic_tensordot(row, t3, 3) == \
        jax_mul.symbolic_tensordot(row, t3, 3)
