"""
Native CPU oracle (ctypes)
==========================

Reference-semantics sparse contractions and the RK4 trajectory loop in C++
(``qgs_kernels.cpp``, the same source as the JAX package's native oracle):
a scalar accumulation over the COO entries in storage order, built with
``-ffp-contract=off``, so that it reproduces the reference's summation
order and :mod:`qgs_tpu_torch.models.numpy_backend` bit for bit.  It is a
CPU reference for the port's tests and ``chip_smoke.py``; nothing on the
card's path calls it.

The library is built with ``g++`` at first use (never at import) into
``qgs_tpu_torch/_build/``, named by a hash of the source, the flags, the
compiler and the CPU that ``-march=native`` resolves to.  Each build
compiles to a temporary file tagged with its process id and moves it into
place with :func:`os.replace`, so processes that build at once never load
a half-written library.  A failed build or load raises with the
compiler's output; it is not remembered, so the next call tries again.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
SOURCE = _HERE / "qgs_kernels.cpp"
BUILD_DIR = _HERE.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC")

_lib = None


def available():
    """Whether a C++ compiler (``g++``) is on the ``PATH``: the oracle is
    built with it at first use."""
    return shutil.which("g++") is not None


def _gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native oracle of qgs_tpu_torch "
                           "is built with g++ at first use")
    return gxx


def library_path():
    """Where the library of this source, these flags, this compiler and
    this CPU lives (built or not)."""
    gxx = _gxx()
    probe = subprocess.run([gxx, "--version"], capture_output=True, text=True,
                           check=True).stdout
    target = subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, check=True).stdout
    march = [ln.split()[-1] for ln in target.splitlines()
             if ln.strip().startswith("-march=")]
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        (*GXX_FLAGS, probe, *march)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libqgs_native_{digest}.so"


def _declare(lib):
    c_i64 = ctypes.c_int64
    c_pd = ctypes.POINTER(ctypes.c_double)
    c_pi = ctypes.POINTER(ctypes.c_int64)
    for name, argtypes, restype in [
        ("sparse_mul3", [c_pi, c_pd, c_i64, c_pd, c_pd, c_i64], None),
        ("sparse_mul2", [c_pi, c_pd, c_i64, c_pd, c_pd, c_i64], None),
        ("sparse_mul5", [c_pi, c_pd, c_i64, c_pd, c_pd, c_i64], None),
        ("sparse_mul4", [c_pi, c_pd, c_i64, c_pd, c_pd, c_i64], None),
        ("rk4_integrate3", [c_pi, c_pd, c_i64, c_pd, c_i64,
                            ctypes.c_double, c_i64, c_i64, c_pd], c_i64),
    ]:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load_library():
    """Build (once per source, flags, compiler and CPU) and load the
    library; raises ``RuntimeError`` with the compiler's output if the
    build fails."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_gxx(), *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    _lib = _declare(ctypes.CDLL(str(so)))
    return _lib


def _ptr_d(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ptr_i(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _prep_coords(tensor):
    """COO coords as a C-contiguous (nnz, rank) int64 array (entry-major,
    matching the kernels' storage-order accumulation)."""
    return np.ascontiguousarray(tensor.coords.T, dtype=np.int64)


def make_native_tendencies(tensor, jtensor):
    """Native f(t, x) / Df(t, x) closures (reference summation order)."""
    lib = load_library()
    rank = tensor.rank
    n1 = tensor.shape[0]
    coords = _prep_coords(tensor)
    data = np.ascontiguousarray(tensor.data, dtype=np.float64)
    jcoords = _prep_coords(jtensor)
    jdata = np.ascontiguousarray(jtensor.data, dtype=np.float64)
    mul_f = lib.sparse_mul3 if rank == 3 else lib.sparse_mul5
    mul_j = lib.sparse_mul2 if rank == 3 else lib.sparse_mul4

    def f(t, x):
        xx = np.concatenate(([1.0], np.asarray(x, np.float64)))
        res = np.empty(n1)
        mul_f(_ptr_i(coords), _ptr_d(data), len(data), _ptr_d(xx),
              _ptr_d(res), n1)
        return res[1:]

    def Df(t, x):
        xx = np.concatenate(([1.0], np.asarray(x, np.float64)))
        res = np.empty((n1, n1))
        mul_j(_ptr_i(jcoords), _ptr_d(jdata), len(jdata), _ptr_d(xx),
              _ptr_d(res), n1)
        return res[1:, 1:]

    return f, Df


def rk4_integrate(tensor, y0, dt, n_steps, write_steps=0):
    """Native single-trajectory RK4 over a rank-3 tensor.

    Returns ``(y_final, recorded)`` with ``recorded`` of shape
    (n_records, ndim) when ``write_steps > 0`` else None."""
    lib = load_library()
    if tensor.rank != 3:
        raise ValueError(f"rk4_integrate takes a rank-3 tensor, not rank "
                         f"{tensor.rank}")
    coords = _prep_coords(tensor)
    data = np.ascontiguousarray(tensor.data, dtype=np.float64)
    y = np.array(y0, dtype=np.float64)
    ndim = y.size
    if ndim != tensor.shape[0] - 1:
        raise ValueError(f"state of {ndim} variables for a tensor of shape "
                         f"{tensor.shape}")
    if write_steps > 0:
        n_rec = n_steps // write_steps + 2
        recorded = np.zeros((n_rec, ndim))
        rec_ptr = _ptr_d(recorded)
    else:
        recorded, rec_ptr = None, _ptr_d(np.zeros(1))
    n_written = lib.rk4_integrate3(_ptr_i(coords), _ptr_d(data), len(data),
                                   _ptr_d(y), ndim, float(dt), n_steps,
                                   write_steps, rec_ptr)
    if write_steps > 0:
        return y, recorded[:n_written]
    return y, None
