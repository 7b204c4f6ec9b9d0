"""
Multi-process execution (torch.distributed)
===========================================

Counterpart of :mod:`qgs_tpu.parallel.distributed`, on
:mod:`torch.distributed`:

* :func:`initialize` joins the process group of a multi-process job
  (launched by ``torchrun``, or told its address, size and rank); each
  process drives its own devices (``local_devices``, with
  ``is_distributed`` defined in :mod:`qgs_tpu_torch.parallel.mesh`);
* :func:`host_chip_mesh` lays every process's devices out as a 2-D
  ``('ensemble', 'model')`` mesh in which each model group lies inside one
  process, so that the ensemble axis alone spans processes and the only
  traffic between them is one all-gather of the results;
* :func:`make_global_array` gives a process its shards of a host array
  that every process holds, and :func:`gather_to_host` all-gathers the
  blocks back.

The group's backend is NCCL for CUDA tensors and gloo for CPU tensors.
NCCL refuses two ranks on one card, so the two-process self-test on a
single card (:func:`run_multiprocess_selftest`) runs over gloo, its CUDA
blocks gathered through host memory.  On a node of N cards the same
self-test runs one process a card over NCCL::

    torchrun --nproc_per_node=N -m qgs_tpu_torch.parallel.distributed
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from qgs_tpu_torch.parallel import mesh as _mesh
from qgs_tpu_torch.parallel.mesh import (  # noqa: F401 (re-exported)
    ENSEMBLE_AXIS, MODEL_AXIS, Mesh, is_distributed, local_devices,
    shard_ensemble,
)

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               local_device_ids=None, backend=None):
    """Join the job's process group; idempotent.

    With no arguments the environment ``torchrun`` sets (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) is used, and
    nothing happens where nothing says the run is multi-process.
    ``coordinator_address`` is ``host:port`` of rank 0.
    ``local_device_ids`` are the card indices this process drives (default
    ``LOCAL_RANK``'s card under ``torchrun``, else every card): they become
    :func:`local_devices`, and the first is made the current card.
    ``backend`` defaults to NCCL for CUDA tensors and gloo for CPU tensors
    (``'cpu:gloo,cuda:nccl'``) where there is a card, else gloo."""
    if dist.is_initialized():
        return
    has_env = all(k in os.environ for k in _TORCHRUN_ENV)
    if coordinator_address is None and num_processes is None and not has_env:
        return
    rank = process_id if process_id is not None else int(
        os.environ.get("RANK", 0))
    world = num_processes if num_processes is not None else int(
        os.environ["WORLD_SIZE"])
    if backend is None:
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   else "gloo")
    card = int(os.environ.get("LOCAL_RANK", 0))
    if local_device_ids is not None:
        _mesh.LOCAL_DEVICE_IDS = [int(i) for i in local_device_ids]
        card = _mesh.LOCAL_DEVICE_IDS[0]
    if "nccl" in backend:
        torch.cuda.set_device(card)
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)


def shutdown():
    """Leave the process group (no-op outside one) and forget
    ``local_device_ids``."""
    _mesh.LOCAL_DEVICE_IDS = None
    if dist.is_initialized():
        dist.destroy_process_group()


def host_chip_mesh(model_axis_size=1, devices=None):
    """The 2-D ``('ensemble', 'model')`` mesh over every process's devices.

    ``devices`` are this process's (default :func:`local_devices`); in a
    multi-process run each process passes its own and the lists are
    gathered, in rank order.  Each run of ``model_axis_size`` consecutive
    devices of one process is a model group; ``model_axis_size`` must
    divide the per-process device count, which must be the same in every
    process."""
    mine = [str(d) for d in (local_devices() if devices is None
                             else devices)]
    per_process = [mine]
    if is_distributed():
        per_process = [None] * dist.get_world_size()
        dist.all_gather_object(per_process, mine)
    local = len(per_process[0])
    if any(len(p) != local for p in per_process):
        raise ValueError("every process must drive the same number of "
                         f"devices, got {[len(p) for p in per_process]}")
    if model_axis_size < 1 or local % model_axis_size != 0:
        raise ValueError(
            f"model_axis_size={model_axis_size} must divide the per-process "
            f"device count ({local})")
    rows = len(per_process) * local // model_axis_size
    grid = np.array([d for p in per_process for d in p], dtype=object)
    procs = np.repeat(np.arange(len(per_process)), local)
    return Mesh(grid.reshape(rows, model_axis_size),
                (ENSEMBLE_AXIS, MODEL_AXIS),
                procs.reshape(rows, model_axis_size))


def make_global_array(host_array, mesh):
    """This process's shards of a host array that every process holds, split
    along its leading (ensemble) axis, which the mesh's ensemble axis must
    divide."""
    if np.shape(host_array)[0] % mesh.shape[ENSEMBLE_AXIS]:
        raise ValueError(f"batch {np.shape(host_array)[0]} does not divide "
                         f"over {mesh.shape[ENSEMBLE_AXIS]} ensemble entries")
    return shard_ensemble(host_array, mesh)[0]


def all_gather_blocks(block, dim=0):
    """Every process's ``block`` (equal shapes) concatenated along ``dim``
    in rank order, on ``block``'s device: one all-gather, on the card where
    the group runs NCCL, else through host memory over gloo."""
    backend = str(dist.get_backend())
    src = block.movedim(dim, 0).contiguous()
    if not ("nccl" in backend and src.is_cuda):
        src = src.cuda() if "gloo" not in backend else src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(block.device).movedim(0, dim)


def gather_to_host(arr, n=None):
    """The full value of an ensemble-sharded array as a NumPy array on every
    process: ``arr`` is this process's block (a tensor, or its shards in
    order), all-gathered along the leading axis when a process group is up
    (every process must call this), then cut to ``n`` rows."""
    if isinstance(arr, (list, tuple)):
        arr = torch.cat([s.to(arr[0].device) for s in arr])
    if dist.is_initialized():
        arr = all_gather_blocks(arr)
    return arr[slice(n)].cpu().numpy()


# ---------------------------------------------------------------------------
# multi-process self-test
# ---------------------------------------------------------------------------

def free_port():
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_multiprocess_selftest(num_processes=2, local_devices=2,
                              model_axis_size=1, timeout=900, device="cpu"):
    """Spawn ``num_processes`` processes, each driving ``local_devices``
    entries of ``device`` (``'cpu'``, or ``'cuda'``: every process on the
    first card), joined over gloo, and run the self-test of
    :func:`_selftest_worker` in each: the ensemble, TGLS, BLV and twofloat
    paths on a mesh that spans the processes, and with
    ``model_axis_size > 1`` the row-sharded tendency, each held against a
    single-device run.

    Raises ``RuntimeError`` on any worker's failure; returns the workers'
    ``DISTOK`` report lines."""
    port = free_port()
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    for k in _TORCHRUN_ENV + ("LOCAL_RANK",):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "qgs_tpu_torch.parallel.distributed",
         str(pid), str(num_processes), str(port), str(model_axis_size),
         str(local_devices), device],
        env=env, cwd=repo_root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for pid in range(num_processes)]
    reports, failures = [], []
    try:
        for pid, proc in enumerate(procs):
            try:
                out, _ = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
                failures.append(f"worker {pid} timed out\n{out[-2000:]}")
                continue
            ok = [ln for ln in out.splitlines() if ln.startswith("DISTOK")]
            if proc.returncode != 0 or not ok:
                failures.append(f"worker {pid} rc={proc.returncode}\n"
                                f"{out[-2000:]}")
            reports.extend(ok)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failures:
        raise RuntimeError("multi-process selftest failed:\n"
                           + "\n".join(failures))
    return reports


def _selftest_worker(model_axis_size, devices):
    """Body of one self-test process, in a process group already joined:
    MAOOAM on a mesh of every process's ``devices``
    (:func:`host_chip_mesh`), against the same computation unsharded on
    this process's first device, at rtol 1e-12 and atol 1e-14.  Fails if
    ``jax`` or ``qgs_tpu`` got imported."""
    from qgs_tpu_torch.params.params import QgParams
    from qgs_tpu_torch.integrators.integrator import (
        RungeKuttaIntegrator, RungeKuttaTglsIntegrator)
    from qgs_tpu_torch.integrators.rk import make_rk_step, rk4_tableau
    from qgs_tpu_torch.models.tendencies import create_tendencies
    from qgs_tpu_torch.parallel.mesh import ensemble_mesh
    from qgs_tpu_torch.parallel.sharded_tendency import make_sharded_tendency
    from qgs_tpu_torch.toolbox.lyapunov import compute_backward_lyapunovs

    tol = dict(rtol=1e-12, atol=1e-14)

    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_oceanic_basin_fourier_modes(2, 4)
    pars.set_params({'kd': 0.0290, 'kdp': 0.0290, 'n': 1.5, 'r': 1.e-7,
                     'h': 136.5, 'd': 1.1e-7})
    pars.atemperature_params.set_params({'eps': 0.7, 'T0': 289.3,
                                         'hlambda': 15.06})
    pars.gotemperature_params.set_params({'gamma': 5.6e8, 'T0': 301.46})
    pars.atemperature_params.set_insolation(103.3333, 0)
    pars.gotemperature_params.set_insolation(310., 0)
    f, Df, tensor = create_tendencies(pars, return_qgtensor=True,
                                      device=devices[0])

    mesh = host_chip_mesh(model_axis_size, devices)
    B = 2 * mesh.shape[ENSEMBLE_AXIS]
    ic = np.random.default_rng(7).random((B, pars.ndim)) * 0.01
    single = ensemble_mesh(devices[:1])

    def run(cls, m, *args, **kw):
        integ = cls(mesh=m, **kw)
        integ.set_func(*args)
        return integ

    # -- the ensemble axis spans the processes -------------------------------
    out = {}
    for m in (mesh, single):
        integ = run(RungeKuttaIntegrator, m, f)
        integ.integrate(0., 5., 0.1, ic=ic, write_steps=10)
        out[m] = integ.get_trajectories()[1].cpu().numpy()
    np.testing.assert_allclose(out[mesh], out[single], **tol)
    records = out[mesh].shape

    # -- TGLS: the fundamental matrices sharded with the states --------------
    for m in (mesh, single):
        tgls = run(RungeKuttaTglsIntegrator, m, f, Df)
        tgls.integrate(0., 1., 0.1, ic=ic, tg_ic=np.eye(pars.ndim),
                       write_steps=0)
        out[m] = tgls.get_trajectories()[2].cpu().numpy()
    np.testing.assert_allclose(out[mesh], out[single], **tol)

    # -- a short BLV run, the tangent blocks sharded -------------------------
    for m in (mesh, single):
        _, _, exps, vecs = compute_backward_lyapunovs(
            f.batched, Df.batched, 0., 0.5, 1.5, 0.1, 0.1, ic,
            write_steps=0, mesh=m)
        out[m] = (exps.cpu().numpy(), vecs.cpu().numpy())
    for a, b in zip(out[mesh], out[single]):
        np.testing.assert_allclose(a, b, **tol)

    # -- twofloat: per-member arithmetic, so equal to the single device ----
    for m in (mesh, single):
        integ = run(RungeKuttaIntegrator, m, f, precision="twofloat")
        integ.integrate(0., 1., 0.1, ic=ic, write_steps=0)
        out[m] = integ.get_trajectories()[1].cpu().numpy()
    np.testing.assert_allclose(out[mesh], out[single], **tol)

    # -- the model axis: rows dealt over each model group, one gather --------
    checks = "ensemble,tgls,blv,twofloat"
    if model_axis_size > 1:
        step_ref = make_rk_step(f.batched, *rk4_tableau())
        y_ref = step_ref(torch.as_tensor(ic, device=devices[0]), 0., 0.1)
        x = make_global_array(ic, mesh)
        for kernel in ("bucketed", "dense"):
            f_sh = make_sharded_tendency(tensor.tensor, mesh, kernel=kernel)
            y = make_rk_step(f_sh, *rk4_tableau())(
                torch.cat([s.to(devices[0]) for s in x]), 0., 0.1)
            np.testing.assert_allclose(gather_to_host(y),
                                       y_ref.cpu().numpy(), **tol)
        checks += ",model-rowshard,model-dense"

    leaked = sorted(m for m in ("jax", "qgs_tpu") if m in sys.modules)
    if leaked:
        raise RuntimeError(f"{' and '.join(leaked)} got imported")
    print(f"DISTOK process={dist.get_rank()}/{dist.get_world_size()} "
          f"mesh={mesh.shape} B={B} ndim={pars.ndim} records={records} "
          f"device={devices[0]} checks={checks}", flush=True)
    shutdown()


def _main(argv):
    """``python -m qgs_tpu_torch.parallel.distributed PID N PORT MODEL
    LOCAL DEVICE``, as :func:`run_multiprocess_selftest` spawns it (gloo;
    ``LOCAL`` entries of ``cpu``, or of the first card); with no arguments,
    one process of a ``torchrun`` job, each on its own card
    (:func:`local_devices`, NCCL for the card's tensors), the model axis 1."""
    if not argv:
        initialize()
        if not dist.is_initialized():
            raise RuntimeError("no arguments and no torchrun environment: "
                               "run under torchrun, or call "
                               "run_multiprocess_selftest")
        _selftest_worker(1, local_devices())
        return
    pid, n, port, model_axis_size, n_local = (int(a) for a in argv[:5])
    if argv[5] == "cpu":
        torch.set_num_threads(1)        # tiny tensors, several processes
    initialize(f"localhost:{port}", n, pid, backend="gloo")
    device = torch.device("cuda", 0) if argv[5] == "cuda" \
        else torch.device(argv[5])
    _selftest_worker(model_axis_size, [device] * n_local)


if __name__ == "__main__":
    _main(sys.argv[1:])
