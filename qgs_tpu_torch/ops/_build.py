"""
Build of the CUDA kernels
=========================

The kernels in ``qgs_tpu_torch/csrc/`` have a plain C interface and include
no PyTorch headers.  At first use each source is compiled with ``nvcc`` for
Hopper (``sm_90a``), all at once in parallel, and the objects are linked into
one shared library under ``qgs_tpu_torch/_build/`` (named by a hash of the
sources and the headers they include, so an edited file is rebuilt), loaded
with :mod:`ctypes`.
Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("rk4_fused.cu", "rk4_df_fused.cu", "rk4_streamed.cu",
           "rk4_df_streamed.cu")
HEADERS = ("rk4_common.cuh", "stream_ring.cuh", "df_ops.cuh")
# flags of each source's compile (the link adds -shared)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_log = ""          # nvcc's output of the last build in this process
_smem_optin = {}        # card index -> its opt-in shared memory a block


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of qgs_tpu_torch are "
                       "built with the CUDA toolkit's nvcc at first use")


def _declare(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # the resident K1's and K5's launches; the streamed K1's add its scratch
    # and its cluster size, the single-buffer variant's its scratch, K5's
    # paired layout's its pair table and pair count
    resident = [ptr, ptr, i32, i32, i32, ptr, i32, ptr, i32, i32, ptr, ptr]
    streamed = resident[:-1] + [ptr, i32, ptr]
    one_buffer = resident[:-1] + [ptr, ptr]
    paired = resident[:-1] + [ptr, i32, ptr]
    for name, argtypes in (
            ("qgs_rk4_fused_f32", resident), ("qgs_rk4_fused_f64", resident),
            ("qgs_rk4_quartic_f32", resident),
            ("qgs_rk4_quartic_f64", resident),
            ("qgs_rk4_paired_f32", paired), ("qgs_rk4_paired_f64", paired),
            ("qgs_rk4_streamed_f32", streamed),
            ("qgs_rk4_streamed_f64", streamed),
            ("qgs_rk4_streamed_1buf_f32", one_buffer),
            ("qgs_rk4_streamed_1buf_f64", one_buffer),
            ("qgs_rk4_streamed_max_clusters", [i32, i32, i32, i32])):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32
    lib.qgs_rk4_df_fused.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                     ptr, ptr, i32, ptr, i32, i32, ptr, ptr,
                                     ptr]
    lib.qgs_rk4_df_fused.restype = i32
    lib.qgs_rk4_df_streamed.argtypes = [ptr, ptr, i32, i32, i32, ptr, ptr,
                                        i32, ptr, i32, i32, ptr, ptr, ptr,
                                        ptr]
    lib.qgs_rk4_df_streamed.restype = i32
    lib.qgs_cuda_error_string.argtypes = [i32]
    lib.qgs_cuda_error_string.restype = ctypes.c_char_p
    lib.qgs_rk4_fused_smem_bytes.argtypes = [i32, i32, i32, i32]
    lib.qgs_rk4_fused_smem_bytes.restype = ctypes.c_longlong
    lib.qgs_rk4_paired_smem_bytes.argtypes = [i32, i32, i32, i32, i32]
    lib.qgs_rk4_paired_smem_bytes.restype = ctypes.c_longlong
    lib.qgs_rk4_df_fused_smem_bytes.argtypes = [i32, i32, i32]
    lib.qgs_rk4_df_fused_smem_bytes.restype = ctypes.c_longlong
    for name in ("qgs_rk4_streamed_smem_bytes",
                 "qgs_rk4_streamed_1buf_smem_bytes"):
        getattr(lib, name).argtypes = [i32, i32, i32]
        getattr(lib, name).restype = ctypes.c_longlong
    lib.qgs_rk4_df_streamed_smem_bytes.argtypes = [i32, i32]
    lib.qgs_rk4_df_streamed_smem_bytes.restype = ctypes.c_longlong
    lib.qgs_max_smem_optin.argtypes = [i32]
    lib.qgs_max_smem_optin.restype = i32
    return lib


def load_library():
    """Build (once per source version) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    srcs = [CSRC / s for s in SOURCES]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in srcs + [CSRC / h for h in HEADERS])
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libqgs_kernels_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tag = f"{digest}.{os.getpid()}"
        objs = [BUILD_DIR / f"{p.stem}_{tag}.o" for p in srcs]
        try:
            build_log = _compile_and_link(srcs, objs, so)
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
    _lib = _declare(ctypes.CDLL(str(so)))
    return _lib


def _compile_and_link(srcs, objs, so):
    """One ``nvcc -c`` per source, all started together, then one link;
    returns nvcc's output."""
    jobs = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
            for p, o in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in jobs]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(jobs, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
           "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = "".join(outs) + proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, so)
    return log


def error_string(err):
    return load_library().qgs_cuda_error_string(err).decode()


def max_smem_optin(device):
    """The opt-in shared memory of one block (bytes) on the CUDA ``device``,
    read once a card through the library the launchers are in, from the
    attribute they check (``cudaDevAttrMaxSharedMemoryPerBlockOptin``)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{device} has no shared-memory limit: the kernels "
                         "run on CUDA cards")
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index not in _smem_optin:
        got = load_library().qgs_max_smem_optin(index)
        if got < 0:
            raise RuntimeError(f"cannot read cuda:{index}'s shared memory: "
                               f"CUDA error {-got} ({error_string(-got)})")
        _smem_optin[index] = got
    return _smem_optin[index]
