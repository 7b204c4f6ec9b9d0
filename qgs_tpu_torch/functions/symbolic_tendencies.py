"""
Symbolic tendencies export
==========================

Generate the model's ODE right-hand side (and Jacobian) as source code in
``python``, ``julia``, ``fortran``, ``auto`` (AUTO-07p continuation
software) or ``mathematica``, with chosen parameters left free for
continuation studies (ref
``qgs/functions/symbolic_tendencies.py:39-1046``).
"""

from __future__ import annotations

import warnings

from sympy import Symbol

from qgs_tpu_torch.functions.symbolic_mul import (
    symbolic_sparse_mult2, symbolic_sparse_mult3,
    symbolic_sparse_mult4, symbolic_sparse_mult5,
)
from qgs_tpu_torch.tensors.symbolic_qgtensor import (
    SymbolicQgsTensor, SymbolicQgsTensorDynamicT, SymbolicQgsTensorT4,
    collect_parameter_substitutions,
)

python_lang_translation = {'sqrt': 'math.sqrt', 'lambda': 'lmda'}
fortran_lang_translation = {'conjugate': 'CONJG', 'epsilon': 'eps'}
julia_lang_translation = {'**': '^', 'conjugate': 'conj'}
mathematica_lang_translation = {'**': '^'}

_TRANSLATORS = {
    'python': python_lang_translation,
    'fortran': fortran_lang_translation,
    'auto': fortran_lang_translation,
    'julia': julia_lang_translation,
    'mathematica': mathematica_lang_translation,
}


def create_symbolic_tendencies(params, continuation_variables, atm_ip=None,
                               ocn_ip=None, gnd_ip=None, language='python',
                               return_inner_products=False, return_jacobian=False,
                               return_symbolic_eqs=False,
                               return_symbolic_qgtensor=False):
    """Build the symbolic RHS (and optionally Jacobian) of the model and emit
    it as code in the requested language, leaving ``continuation_variables``
    free.

    Returns a list: [func_str, (jac_str), (inner_products), (symbolic_eqs),
    (symbolic tensor)] following the requested flags.
    """
    from qgs_tpu_torch.inner_products.symbolic import (
        AtmosphericSymbolicInnerProducts, OceanicSymbolicInnerProducts,
        GroundSymbolicInnerProducts,
    )

    make_ip_subs = True
    if continuation_variables is None:
        make_ip_subs = False
        continuation_variables = []
        substitute_all = False
    else:
        substitute_all = True
        for cv in continuation_variables:
            try:
                if params.scale_params.n == cv:
                    make_ip_subs = False
            except Exception:
                pass

    if not make_ip_subs:
        warnings.warn("computing the inner products fully symbolically (the "
                      "aspect ratio n is left free) — this may take a while")

    # with the aspect ratio substituted the inner products are plain numbers:
    # use the fast quadrature engine; otherwise exact symbolic integration
    ip_kwargs = (dict(return_symbolic=False, quadrature=True) if make_ip_subs
                 else dict(return_symbolic=True, make_substitution=False,
                           quadrature=False))

    if params.atmospheric_basis is not None:
        aip = atm_ip if atm_ip is not None else AtmosphericSymbolicInnerProducts(
            params, **ip_kwargs)
    else:
        aip = None
    if params.oceanic_basis is not None:
        oip = ocn_ip if ocn_ip is not None else OceanicSymbolicInnerProducts(
            params, **ip_kwargs)
    else:
        oip = None
    if params.ground_basis is not None:
        gip = gnd_ip if gnd_ip is not None else GroundSymbolicInnerProducts(
            params, **ip_kwargs)
    else:
        gip = None

    if aip is not None and oip is not None and not aip.connected_to_ocean:
        aip.connect_to_ocean(oip)
    elif aip is not None and gip is not None and not aip.connected_to_ground:
        aip.connect_to_ground(gip)

    if params.T4:
        agotensor = SymbolicQgsTensorT4(params, aip, oip, gip)
    elif params.dynamic_T:
        agotensor = SymbolicQgsTensorDynamicT(params, aip, oip, gip)
    else:
        agotensor = SymbolicQgsTensor(params, aip, oip, gip)

    xx = [1] + [Symbol('U_' + str(i)) for i in range(1, params.ndim + 1)]

    cv = continuation_variables if substitute_all else None
    sub_kwargs = {'continuation_variables': continuation_variables} \
        if substitute_all else {'continuation_variables': None}

    tdic = (agotensor.sub_tensor(**sub_kwargs) if substitute_all
            else agotensor.tensor_dict)
    if params.dynamic_T:
        eq = symbolic_sparse_mult5(tdic, xx, xx, xx, xx)
    else:
        eq = symbolic_sparse_mult3(tdic, xx, xx)
    eq.pop(0, None)   # dummy row

    dict_eq = None
    if return_jacobian:
        jdic = (agotensor.sub_tensor(agotensor.jac_dic, **sub_kwargs)
                if substitute_all else agotensor.jac_dic)
        if params.dynamic_T:
            dict_eq = symbolic_sparse_mult4(jdic, xx, xx, xx)
        else:
            dict_eq = symbolic_sparse_mult2(jdic, xx)
        dict_eq = {k: v for k, v in dict_eq.items() if k[0] != 0 and k[1] != 0}

    func = equation_as_function(eq, params, continuation_variables, language)
    ret = [func]
    if return_jacobian:
        ret.append(jacobian_as_function(dict_eq, params, continuation_variables,
                                        language))
    if return_inner_products:
        ret.append((aip, oip, gip))
    if return_symbolic_eqs:
        ret.append(eq)
    if return_symbolic_qgtensor:
        ret.append(agotensor)
    return ret


def translate_equations(equations, language='python'):
    """Apply the language-specific token translations."""
    translator = _TRANSLATORS.get(language, {})

    def tr(s):
        for k, v in translator.items():
            s = s.replace(k, v)
        return s

    if isinstance(equations, dict):
        return {k: tr(v) for k, v in equations.items()}
    if isinstance(equations, list):
        return [tr(e) for e in equations]
    if isinstance(equations, str):
        return tr(equations)
    raise ValueError("expected a dict, list, or string")


def format_equations(equations, params, save_loc=None, language='python',
                     print_equations=False):
    """Substitute the state-vector symbols with the language's array syntax
    and evaluate numeric subexpressions."""
    fmt = {
        'python': lambda i: Symbol('U[' + str(i - 1) + ']'),
        'fortran': lambda i: Symbol('U(' + str(i) + ')'),
        'auto': lambda i: Symbol('U(' + str(i) + ')'),
        'julia': lambda i: Symbol('U[' + str(i) + ']'),
        'mathematica': lambda i: Symbol('U(' + str(i) + ')'),
    }[language]
    vector_subs = {Symbol('U_' + str(i)): fmt(i) for i in range(1, params.ndim + 1)}

    out = {}
    for k, expr in equations.items():
        if isinstance(expr, float):
            out[k] = expr
        else:
            out[k] = expr.subs(vector_subs).evalf()
    if print_equations:
        lines = [str(translate_equations(str(e), language)) for e in out.values()]
        if save_loc is None:
            print("\n".join(lines))
        else:
            with open(save_loc, 'w') as f:
                f.write("\n".join(lines) + "\n")
    return out


def equations_to_string(equations):
    return {k: str(v) for k, v in equations.items()}


def _split_equations(eq_dict, f_output, line_len=80, two_dim=False):
    """Split FORTRAN equations into continuation lines."""
    for n, eq in eq_dict.items():
        eq_tr = translate_equations(eq, language='fortran')
        chunks = [eq_tr[x: x + line_len] for x in range(0, len(eq_tr), line_len)]
        lhs = (f'\tJAC({n[0]}, {n[1]}) =\t ' if two_dim else f'\tF({n}) =\t ')
        if len(chunks) > 1:
            f_output.append(lhs + chunks[0] + "&")
            for ln in chunks[1:-1]:
                f_output.append("\t\t&" + ln + "&")
            f_output.append("\t\t&" + chunks[-1])
        else:
            f_output.append(lhs + chunks[0])
        f_output.append('')
    return f_output


def equation_as_function(equations, params, continuation_variables, language='python'):
    """Emit the RHS equations as a function definition string."""
    if continuation_variables is None:
        continuation_variables = []
    eq_dict = equations_to_string(format_equations(equations, params,
                                                   language=language))
    out = []
    if language == 'python':
        head = 'def f(t, U' + ''.join(', ' + str(v.symbol)
                                      for v in continuation_variables) + '):'
        out.append(head)
        out.append('\t# Tendency function of the qgs model')
        for v in continuation_variables:
            out.append('\t# ' + str(v.symbol) + ":\t" + str(v.description))
        out.append('')
        out.append('\tF = np.empty_like(U)')
        for n, eq in eq_dict.items():
            out.append('\tF[' + str(n - 1) + '] = ' + eq)
        out.append('\treturn F')
        return '\n'.join(translate_equations(out, 'python'))

    if language == 'julia':
        out.append('function f!(du, U, p, t)')
        out.append('\t# Tendency function of the qgs model')
        for i, v in enumerate(continuation_variables):
            out.append(f'\t{v.symbol} = p[{i + 1}] \t# {v.description}')
        out.append('')
        for n, eq in eq_dict.items():
            out.append(f'\tdu[{n}] = ' + eq)
        out.append('end')
        return '\n'.join(translate_equations(out, 'julia'))

    if language == 'fortran':
        f_var = ''.join(', ' + str(v.symbol) for v in continuation_variables)
        out.append('SUBROUTINE FUNC(NDIM, t, U, F' + f_var + ')')
        out.append('\t! Tendency function of the qgs model')
        out.append('\tINTEGER, INTENT(IN) :: NDIM')
        out.append('\tDOUBLE PRECISION, INTENT(IN) :: U(NDIM), PAR(*)')
        out.append('\tDOUBLE PRECISION, INTENT(OUT) :: F(NDIM)')
        for v in continuation_variables:
            out.append(f'\tDOUBLE PRECISION, INTENT(IN) :: {v.symbol}\t! {v.description}')
        out.append('')
        out = _split_equations(eq_dict, out)
        out.append('END SUBROUTINE')
        return '\n'.join(translate_equations(out, 'fortran'))

    if language == 'auto':
        eqs = _split_equations(eq_dict, [])
        auto_file, auto_config = create_auto_file(eqs, params,
                                                  continuation_variables)
        return ['\n'.join(translate_equations(auto_file, 'fortran')),
                '\n'.join(translate_equations(auto_config, 'fortran'))]

    if language == 'mathematica':
        out.append('F = Array[f, ' + str(len(eq_dict)) + ']')
        for n, eq in eq_dict.items():
            out.append(f'f[{n}] = ' + eq)
        return '\n'.join(translate_equations(out, 'mathematica'))

    raise ValueError(f"unknown language {language!r}")


def jacobian_as_function(equations, params, continuation_variables,
                         language='python'):
    """Emit the Jacobian equations as a function definition string."""
    if continuation_variables is None:
        continuation_variables = []
    eq_dict = equations_to_string(format_equations(equations, params,
                                                   language=language))
    out = []
    if language == 'python':
        head = 'def jac(t, U' + ''.join(', ' + str(v.symbol)
                                        for v in continuation_variables) + '):'
        out.append(head)
        out.append('\t# Jacobian function of the qgs model')
        out.append('')
        out.append('\tJ = np.zeros((len(U), len(U)))')
        for n, eq in eq_dict.items():
            out.append(f'\tJ[{n[0] - 1}, {n[1] - 1}] = ' + eq)
        out.append('\treturn J')
        return '\n'.join(translate_equations(out, 'python'))

    if language == 'julia':
        out.append('function jac!(du, U, p, t)')
        for i, v in enumerate(continuation_variables):
            out.append(f'\t{v.symbol} = p[{i + 1}]')
        out.append('')
        for n, eq in eq_dict.items():
            out.append(f'\tdu[{n[0]}, {n[1]}] = ' + eq)
        out.append('end')
        return '\n'.join(translate_equations(out, 'julia'))

    if language == 'fortran':
        f_var = ''.join(', ' + str(v.symbol) for v in continuation_variables)
        out.append('SUBROUTINE FUNC(NDIM, t, U, JAC' + f_var + ')')
        out.append('\t! Jacobian function of the qgs model')
        out.append('\tINTEGER, INTENT(IN) :: NDIM')
        out.append('\tDOUBLE PRECISION, INTENT(IN) :: U(NDIM), PAR(*)')
        out.append('\tDOUBLE PRECISION, INTENT(OUT) :: JAC(NDIM, NDIM)')
        out.append('')
        out = _split_equations(eq_dict, out, two_dim=True)
        out.append('END SUBROUTINE')
        return '\n'.join(translate_equations(out, 'fortran'))

    if language == 'auto':
        eqs = _split_equations(eq_dict, [], two_dim=True)
        auto_file, auto_config = create_auto_file(eqs, params,
                                                  continuation_variables)
        return ['\n'.join(translate_equations(auto_file, 'fortran')),
                '\n'.join(translate_equations(auto_config, 'fortran'))]

    raise ValueError(f"unknown language {language!r}")


def create_auto_file(equations, params, continuation_variables,
                     auto_main_template=None, auto_c_template=None,
                     initialize_params=False, initialize_solution=False):
    """Fill the AUTO-07p model and configuration file templates (PAR
    declarations, STPNT initialization, evolution equations)."""
    if not (1 <= len(continuation_variables) <= 10):
        raise ValueError("AUTO requires between 1 and 10 continuation variables")

    declare_var = ['DOUBLE PRECISION ' + str(v.symbol)
                   for v in continuation_variables]
    var_list = [f'{v.symbol} = PAR({i + 1})'
                for i, v in enumerate(continuation_variables)]
    var_ini = [f'PAR({i + 1}) = {float(v)}  ! Variable: {v.symbol}'
               for i, v in enumerate(continuation_variables)]
    sol_ini = [f'U({i}) = 0.0d0' for i in range(1, params.ndim + 1)]

    lines = (auto_main_template or DEFAULT_AUTO_MAIN_TEMPLATE).split('\n')
    auto_file = []
    for ln in lines:
        if 'PARAMETER DECLARATION' in ln:
            auto_file.extend('\t' + dv for dv in declare_var)
        elif 'CONTINUATION PARAMETERS' in ln:
            auto_file.extend('\t' + v for v in var_list)
        elif 'EVOLUTION EQUATIONS' in ln:
            auto_file.extend(equations)
        elif 'INITIALISE PARAMETERS' in ln and initialize_params:
            auto_file.extend('\t' + iv for iv in var_ini)
        elif 'INITIALISE SOLUTION' in ln and initialize_solution:
            auto_file.extend('\t' + iv for iv in sol_ini)
        else:
            auto_file.append(ln)

    lines = (auto_c_template or DEFAULT_AUTO_C_TEMPLATE).split('\n')
    auto_config = []
    for ln in lines:
        if '! PARAMETERS' in ln:
            pd = {i + 1: str(v.symbol) for i, v in enumerate(continuation_variables)}
            pd.update({11: 'T', 12: 'theta', 14: 't', 25: 'T_r'})
            auto_config.append('parnames = ' + str(pd))
        elif '! VARIABLES' in ln:
            auto_config.append('unames = ' + str(
                {i + 1: params.var_string[i] for i in range(params.ndim)}))
        elif '! DIMENSION' in ln:
            auto_config.append('NDIM = ' + str(params.ndim))
        elif '! CONTINUATION ORDER' in ln:
            auto_config.append('ICP = ' + str(
                [str(v.symbol) for v in continuation_variables]))
        elif '! SOLUTION SAVE' in ln:
            auto_config.append("# ! User to input save locations")
            auto_config.append('UZR = ' + str(
                {str(v.symbol): [] for v in continuation_variables}))
        elif '! STOP CONDITIONS' in ln:
            auto_config.append("# ! User to input variable bounds")
            auto_config.append('UZSTOP = ' + str(
                {str(v.symbol): [] for v in continuation_variables}))
        else:
            auto_config.append(ln)

    return auto_file, auto_config


DEFAULT_AUTO_MAIN_TEMPLATE = """!----------------------------------------------------------------------
!   AUTO-07p model file for the qgs-tpu model
!----------------------------------------------------------------------

SUBROUTINE FUNC(NDIM,U,ICP,PAR,IJAC,F,DFDU,DFDP)
\t!--------- ----
\t! Evaluates the ODE right hand side

\tIMPLICIT NONE
\tINTEGER, INTENT(IN) :: NDIM, IJAC, ICP(*)
\tDOUBLE PRECISION, INTENT(IN) :: U(NDIM), PAR(*)
\tDOUBLE PRECISION, INTENT(OUT) :: F(NDIM)
\tDOUBLE PRECISION, INTENT(INOUT) :: DFDU(NDIM,NDIM),DFDP(NDIM,*)

! PARAMETER DECLARATION

! CONTINUATION PARAMETERS

! EVOLUTION EQUATIONS

END SUBROUTINE FUNC

!----------------------------------------------------------------------

SUBROUTINE STPNT(NDIM,U,PAR,T)
\t!--------- -----
\t! Starting solution and parameter values

\tIMPLICIT NONE
\tINTEGER, INTENT(IN) :: NDIM
\tDOUBLE PRECISION, INTENT(INOUT) :: U(NDIM), PAR(*)
\tDOUBLE PRECISION, INTENT(IN) :: T

! INITIALISE PARAMETERS

! INITIALISE SOLUTION

END SUBROUTINE STPNT

SUBROUTINE BCND
END SUBROUTINE BCND

SUBROUTINE ICND
END SUBROUTINE ICND

SUBROUTINE FOPT
END SUBROUTINE FOPT

SUBROUTINE PVLS
END SUBROUTINE PVLS
"""

DEFAULT_AUTO_C_TEMPLATE = """# AUTO-07p configuration file for the qgs-tpu model
! DIMENSION
! PARAMETERS
! VARIABLES
! CONTINUATION ORDER
IPS = 1, IRS = 0, ILP = 1
ICP defined above
NTST = 50, NCOL = 4, IAD = 3, ISP = 2, ISW = 1, IPLT = 0, NBC = 0, NINT = 0
NMX = 2000, NPR = 100, MXBF = 10, IID = 2, ITMX = 8, ITNW = 7, NWTN = 3, JAC = 0
EPSL = 1e-07, EPSU = 1e-07, EPSS = 1e-05
DS = 0.01, DSMIN = 0.001, DSMAX = 0.1, IADS = 1
NPAR = 25, THL = {}, THU = {}
! SOLUTION SAVE
! STOP CONDITIONS
"""
