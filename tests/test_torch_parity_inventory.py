"""The parity inventory of the two packages: every public function, class
and method of the JAX package (``qgs_tpu/``) has its counterpart in the
port (``qgs_tpu_torch/``), with every parameter name, unless
``NOT_CARRIED`` names the difference and the ROADMAP rule that excludes it.

Both packages are read as source (``ast``), and neither is imported.  A
JAX module's counterpart is the port module of the same relative path, or
the modules ``MODULE_MAP`` gives.  Methods are resolved through the
class's bases inside each package, so that inherited methods count.  The
test of a module fails on any difference that the table does not list,
and on a table entry that no longer differs, so the table stays exact.
Parameter names are compared, not their order or defaults; a parameter
that the port requires and the JAX package lacks is a difference too
(``name(+param)``).

Differences are named ``module::name`` (a missing function or class),
``module::Class.method`` (a missing method) and ``module::name(param)``
(a missing parameter)."""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX, PORT = "qgs_tpu", "qgs_tpu_torch"

# JAX module -> its counterparts in the port, where the path differs.  The
# Pallas kernels became CUDA C++ (``qgs_tpu_torch/csrc/``), launched by
# these two modules.
MODULE_MAP = {"ops/pallas_kernels.py": ["ops/fused_rk4.py",
                                        "ops/fused_df_rk4.py"]}

# The ROADMAP rules ("Rules for every slice", "Do not carry TPU
# workarounds into the port") that the differences below fall under.
OPERANDS = ("XLA operand threading and executable caches: Contraction "
            "and _cached_apply")
MODES = ("the comparison-only contraction modes: one path, the mode= "
         "names accepted")
CHUNKING = "VMEM-knee batch chunking: _chunk_batched and QGS_*_BATCH_CHUNK"
BUCKETS = "the compile-latency bucket DP: _count_thresholds"
PRECISION = ("the TPU's matmul precision (jax.lax.Precision): the H100 "
             "has native float64")
ONE_HOT = "one-hot matmul gathers (gather='onehot')"
DF_ACCUMULATE = ("double-float summation modes (accumulate=): one "
                 "accumulation order")
DF_MODULES = ("the double-float step builders take DfTendency / DfTangent "
              "modules (which replace make_df_quadratic and carry the "
              "adjoint and inverse transforms); the entry points take the "
              "COO tensors")
BARRIERS = "the x64 scoping and no_barriers around Pallas"
EMULATED_F64 = ("cholqr_df, df_matmul and trisolve_mp exist only to avoid "
                "the TPU's emulated float64")
SHARDING = ("JAX sharding (shard_map, NamedSharding, PartitionSpec): a "
            "sharded array is the list of its shards")
PAIRS = ("the count-bucket ladder and pair factoring of the bucketed "
         "kernel (the parallel layer)")
PALLAS = ("the Pallas kernels became CUDA C++: K1 csrc/rk4_fused.cu "
          "(fused_rk4), K2 csrc/rk4_df_fused.cu (fused_df_rk4)")

NOT_CARRIED = {
    # integrators/rk.py
    "integrators/rk.py::integrate_runge_kutta(batch_devices)": CHUNKING,
    "integrators/rk.py::integrate_runge_kutta_df(batch_devices)": CHUNKING,
    "integrators/rk.py::integrate_runge_kutta_df(gather)": ONE_HOT,
    "integrators/rk.py::integrate_runge_kutta_df(accumulate)": DF_ACCUMULATE,
    "integrators/rk.py::integrate_runge_kutta_tgls_df(gather)": ONE_HOT,
    "integrators/rk.py::integrate_runge_kutta_tgls_df(accumulate)":
        DF_ACCUMULATE,
    # models/tendencies.py
    "models/tendencies.py::create_tendencies(precision)": PRECISION,
    "models/tendencies.py::create_atmo_thermo_tendencies(precision)":
        PRECISION,
    # ops/contraction.py
    "ops/contraction.py::Contraction": OPERANDS,
    "ops/contraction.py::jit_contraction": OPERANDS,
    "ops/contraction.py::make_dense_quadratic": MODES,
    "ops/contraction.py::make_dense_bilinear": MODES,
    "ops/contraction.py::make_coo_contraction": MODES,
    "ops/contraction.py::make_coo_jacobian": MODES,
    "ops/contraction.py::make_rowsum_contraction": MODES,
    "ops/contraction.py::make_pairsum_contraction": MODES,
    "ops/contraction.py::make_bucketed_contraction": BUCKETS,
    "ops/contraction.py::default_max_buckets": BUCKETS,
    "ops/contraction.py::make_direct_tangent(precision)": PRECISION,
    "ops/contraction.py::make_tendency_fns(precision)": PRECISION,
    # ops/pallas_kernels.py
    "ops/pallas_kernels.py::make_pallas_rk4_f32": PALLAS,
    "ops/pallas_kernels.py::make_pallas_df_rk4": PALLAS,
    # ops/twofloat.py
    "ops/twofloat.py::no_barriers": BARRIERS,
    "ops/twofloat.py::df_matmul": EMULATED_F64,
    "ops/twofloat.py::trisolve_mp": EMULATED_F64,
    "ops/twofloat.py::cholqr_df": EMULATED_F64,
    "ops/twofloat.py::make_df_quadratic": DF_MODULES,
    "ops/twofloat.py::df_neg": DF_MODULES,
    "ops/twofloat.py::make_df_tangent_contraction(accumulate)":
        DF_ACCUMULATE,
    **{f"ops/twofloat.py::{fn}({p})": DF_MODULES
       for fn in ("make_df_rk4_step", "make_df_rk4_step_dynamic",
                  "make_df_rk_step_dynamic")
       for p in ("tensor", "gather", "accumulate", "+f")},
    **{f"ops/twofloat.py::{fn}({p})": DF_MODULES
       for fn in ("make_df_tgls_rk4_step", "make_df_tgls_rk4_step_dynamic",
                  "make_df_tgls_rk_step_dynamic")
       for p in ("tensor", "jtensor", "adjoint", "inverse", "gather",
                 "accumulate", "+f", "+tangent")},
    # parallel/
    "parallel/distributed.py::make_global_array(pspec)": SHARDING,
    "parallel/mesh.py::ensemble_sharding": SHARDING,
    "parallel/sharded_tendency.py::shard_map": SHARDING,
    "parallel/sharded_tendency.py::partial_shard_map": SHARDING,
    "parallel/sharded_tendency.py::make_bucketed_sharded_tendency"
    "(factor_pairs)": PAIRS,
    "parallel/sharded_tendency.py::make_bucketed_sharded_tendency"
    "(max_buckets)": PAIRS,
    # toolbox/lyapunov.py
    "toolbox/lyapunov.py::make_window_step_df(tensor)": DF_MODULES,
    "toolbox/lyapunov.py::make_window_step_df(jtensor)": DF_MODULES,
    "toolbox/lyapunov.py::make_window_step_df(+f)": DF_MODULES,
    "toolbox/lyapunov.py::make_window_step_df(+tangent)": DF_MODULES,
}

_TREES = {}


def _tree(path):
    """The parsed module at ``path``, or None where there is no file."""
    if path not in _TREES:
        _TREES[path] = ast.parse(path.read_text()) if path.exists() else None
    return _TREES[path]


def _module_path(dotted):
    """The file of a dotted module name inside the repository."""
    p = REPO.joinpath(*dotted.split("."))
    return p / "__init__.py" if (p / "__init__.py").exists() \
        else p.with_suffix(".py")


def _resolve(path, name, package):
    """``(node, path)`` of the definition that ``name`` is bound to in the
    module at ``path``: a function or class defined there, an alias of one
    (``a = b``), or a name imported from another module of ``package``;
    ``(None, None)`` where the module binds no such name."""
    tree = _tree(path)
    if tree is None:
        return None, None
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and node.name == name:
            return node, path
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Name) \
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in node.targets):
            return _resolve(path, node.value.id, package)
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[0] == package:
            for alias in node.names:
                if (alias.asname or alias.name) == name:
                    return _resolve(_module_path(node.module), alias.name,
                                    package)
    return None, None


def _methods(cls, path, package):
    """Every method of a class, its bases' (inside ``package``) first, so
    that a method the class defines overrides theirs."""
    out = {}
    for base in cls.bases:
        if isinstance(base, ast.Name):
            node, p = _resolve(path, base.id, package)
            if isinstance(node, ast.ClassDef):
                out.update(_methods(node, p, package))
    out.update((n.name, n) for n in cls.body
               if isinstance(n, ast.FunctionDef))
    return out


def _params(fn):
    """A function's parameter names (``*args``, ``**kw`` with their stars),
    without ``self`` / ``cls``; and the names of those without a default."""
    a = fn.args
    positional = a.posonlyargs + a.args
    names = [x.arg for x in positional + a.kwonlyargs]
    required = [x.arg for x in positional[:len(positional)
                                          - len(a.defaults)]]
    required += [x.arg for x, d in zip(a.kwonlyargs, a.kw_defaults)
                 if d is None]
    if a.vararg:
        names.append("*" + a.vararg.arg)
    if a.kwarg:
        names.append("**" + a.kwarg.arg)
    drop = ("self", "cls")
    return ([n for n in names if n not in drop],
            [n for n in required if n not in drop])


def _public(name):
    return not name.startswith("_") or name in ("__init__", "__call__")


def _public_items(tree, path):
    """``(name, node)`` of the module's public functions and classes and of
    its public aliases of them."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and _public(node.name):
            yield node.name, node
        elif isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Name):
            for t in node.targets:
                if isinstance(t, ast.Name) and _public(t.id):
                    target, _ = _resolve(path, node.value.id, JAX)
                    if target is not None:
                        yield t.id, target


def _param_diffs(key, jax_fn, port_fn):
    jax_names, _ = _params(jax_fn)
    port_names, port_required = _params(port_fn)
    return ([f"{key}({p})" for p in jax_names if p not in port_names]
            + [f"{key}(+{p})" for p in port_required
               if p not in jax_names])


def differences(rel):
    """Every difference of the port from the JAX module ``rel`` (a path
    under ``qgs_tpu/``)."""
    jax_path = REPO / JAX / rel
    ports = [REPO / PORT / r for r in MODULE_MAP.get(rel, [rel])]
    if not any(p.exists() for p in ports):
        return [f"{rel}::"]
    out = []
    for name, node in _public_items(_tree(jax_path), jax_path):
        key = f"{rel}::{name}"
        found = next(((n, p) for n, p in (_resolve(p, name, PORT)
                                          for p in ports) if n is not None),
                     None)
        if found is None:
            out.append(key)
            continue
        port_node, port_path = found
        if isinstance(node, ast.FunctionDef):
            if not isinstance(port_node, ast.FunctionDef):
                out.append(key + " (not a function)")
                continue
            out += _param_diffs(key, node, port_node)
            continue
        if not isinstance(port_node, ast.ClassDef):
            out.append(key + " (not a class)")
            continue
        port_methods = _methods(port_node, port_path, PORT)
        for m, fn in _methods(node, jax_path, JAX).items():
            if not _public(m):
                continue
            if m not in port_methods:
                out.append(f"{key}.{m}")
            else:
                out += _param_diffs(f"{key}.{m}", fn, port_methods[m])
    return out


JAX_MODULES = sorted(str(p.relative_to(REPO / JAX))
                     for p in (REPO / JAX).rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_module_parity(rel):
    """Every difference of the port from this JAX module is in
    ``NOT_CARRIED``, and every entry of the table for this module still
    differs."""
    found = set(differences(rel))
    listed = {k for k in NOT_CARRIED if k.split("::")[0] == rel}
    assert not found - listed, ("differences that NOT_CARRIED does not "
                                f"list: {sorted(found - listed)}")
    assert not listed - found, ("NOT_CARRIED entries that no longer "
                                f"differ: {sorted(listed - found)}")


def test_table_names_jax_modules_and_reasons():
    """Every entry of the table names a JAX module and gives a reason."""
    assert len(JAX_MODULES) > 50
    for key, reason in NOT_CARRIED.items():
        assert key.split("::")[0] in JAX_MODULES, key
        assert reason.strip(), key


def test_inventory_sees_what_it_compares():
    """The walk resolves the port's re-exports and inherited methods and
    reports a missing parameter, a missing name and a required extra
    parameter, on the packages' own sources."""
    node, path = _resolve(REPO / PORT / "parallel/distributed.py",
                          "is_distributed", PORT)
    assert isinstance(node, ast.FunctionDef)
    assert path.name == "mesh.py"
    est, est_path = _resolve(REPO / PORT / "toolbox/lyapunov.py",
                             "LyapunovsEstimator", PORT)
    assert {"set_func", "start", "terminate", "set_bca"} \
        <= set(_methods(est, est_path, PORT))
    jax_fn, _ = _resolve(REPO / JAX / "integrators/rk.py", "rk4_tableau",
                         JAX)
    one = ast.parse("def rk4_tableau():\n    pass\n").body[0]
    two = ast.parse("def rk4_tableau(dtype, extra):\n    pass\n").body[0]
    assert _param_diffs("k", jax_fn, one) == ["k(dtype)"]
    assert _param_diffs("k", jax_fn, two) == ["k(+extra)"]
    assert "ops/twofloat.py::cholqr_df" in differences("ops/twofloat.py")
