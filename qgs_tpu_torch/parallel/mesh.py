"""
Device meshes (ensemble parallelism)
====================================

Counterpart of :mod:`qgs_tpu.parallel.mesh`: the ensemble (batch) axis of a
state is split into contiguous shards, one per entry of a mesh's
``'ensemble'`` axis, and each shard is integrated on its entry's device by
a copy of the tendency module there.  Trajectories do not interact, so no
collective runs while they are integrated; the shards are concatenated on
the mesh's first device afterwards (:func:`gather_ensemble`), and across
processes by one all-gather (:mod:`qgs_tpu_torch.parallel.distributed`).

:class:`Mesh` stands for ``jax.sharding.Mesh`` over the two axes this
package uses, ``'ensemble'`` and ``'model'``.  There is no counterpart of
``ensemble_sharding``/``NamedSharding``: a sharded array is the list of its
shards on their devices (:func:`shard_ensemble`), which is all the
integrators need.  A mesh may name a device more than once (the counterpart
of the JAX tests' virtual host devices): that is how the split runs on one
card, or on the CPU.
"""

from __future__ import annotations

import copy
import os
import weakref

import numpy as np
import torch
import torch.distributed as dist

ENSEMBLE_AXIS = "ensemble"
MODEL_AXIS = "model"


def _device(d):
    """``d`` as a :class:`torch.device`, a CUDA device with its index (the
    current card's where ``d`` names none)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def process_rank():
    """This process's rank in its process group (0 outside one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def is_distributed():
    """True when this program runs as one process of a multi-process job."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


# The card indices this process drives, where ``distributed.initialize``
# was given ``local_device_ids``.
LOCAL_DEVICE_IDS = None


def local_devices():
    """The devices this process drives: the cards of ``local_device_ids``
    where :func:`~qgs_tpu_torch.parallel.distributed.initialize` was given
    them, else its card ``cuda:LOCAL_RANK`` in a multi-process job started
    by ``torchrun``, else every visible card.  Without a card this raises:
    pass devices (``'cpu'``) explicitly."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is visible: name the devices (for example "
            "ensemble_mesh(['cpu'] * 8)) to run on the CPU")
    if LOCAL_DEVICE_IDS is not None:
        return [torch.device("cuda", int(i)) for i in LOCAL_DEVICE_IDS]
    if is_distributed() and "LOCAL_RANK" in os.environ:
        return [torch.device("cuda", int(os.environ["LOCAL_RANK"]))]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """An ordered grid of devices with named axes, the first one
    ``'ensemble'`` (the second, where there is one, ``'model'``).

    ``processes`` holds the rank of the process that drives each entry (all
    this process's rank by default): a multi-process mesh is built by
    :func:`~qgs_tpu_torch.parallel.distributed.host_chip_mesh`, its
    ensemble entries ordered by process.  The mesh also keeps the copies of
    the tendency modules it has made on its devices (:meth:`replica`)."""

    def __init__(self, devices, axis_names=(ENSEMBLE_AXIS,), processes=None):
        grid = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if grid.ndim != len(self.axis_names) or grid.size == 0:
            raise ValueError(f"a mesh of axes {self.axis_names} needs a "
                             f"non-empty {len(self.axis_names)}-D device grid, "
                             f"got shape {grid.shape}")
        if self.axis_names[0] != ENSEMBLE_AXIS or not set(
                self.axis_names) <= {ENSEMBLE_AXIS, MODEL_AXIS}:
            raise ValueError(f"mesh axes {self.axis_names}: expected "
                             f"('{ENSEMBLE_AXIS}',) or ('{ENSEMBLE_AXIS}', "
                             f"'{MODEL_AXIS}')")
        flat = np.empty(grid.size, dtype=object)
        flat[:] = [_device(d) for d in grid.ravel()]
        if len({d.type for d in flat}) > 1:
            raise ValueError("a mesh holds devices of one type, got "
                             f"{sorted({d.type for d in flat})}")
        self.devices = flat.reshape(grid.shape)
        if processes is None:
            processes = np.full(grid.shape, process_rank())
        self.processes = np.asarray(processes, dtype=np.int64)
        if self.processes.shape != grid.shape or np.any(
                np.diff(self.processes.reshape(grid.shape[0], -1)[:, 0]) < 0):
            raise ValueError("processes must match the device grid and run "
                             "in order along the ensemble axis")
        self._replicas = weakref.WeakKeyDictionary()

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return self.devices.size

    def spans_processes(self):
        return len(set(self.processes.ravel().tolist())) > 1

    def local_groups(self):
        """The device groups (rows of the ``'model'`` axis) of the ensemble
        entries this process drives, in ensemble order."""
        rows = self.devices.reshape(self.devices.shape[0], -1)
        mine = self.processes.reshape(rows.shape)[:, 0] == process_rank()
        return [list(r) for r in rows[mine]]

    def replica(self, fn, device):
        """``fn`` on ``device``: itself where it carries no ``.device`` (a
        plain callable, called with each shard as it is) or lives there,
        else a copy moved there (a ``Tendency``, ``DfTendency``, ``Jacobian``
        or tangent module), made once per function and device."""
        home = getattr(fn, "device", None)
        if home is None or torch.device(home) == device:
            return fn
        copies = self._replicas.setdefault(fn, {})
        if device not in copies:
            copies[device] = copy.deepcopy(fn).to(device)
        return copies[device]

    def __repr__(self):
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.ravel()]})")


def ensemble_mesh(devices=None):
    """A 1-D ``'ensemble'`` mesh over ``devices`` (entries may repeat),
    by default every visible CUDA card, and in a multi-process run every
    process's cards (:func:`~qgs_tpu_torch.parallel.distributed.host_chip_mesh`).
    Without a card the default raises: there is no CPU fallback."""
    if devices is None:
        if is_distributed():
            from qgs_tpu_torch.parallel.distributed import host_chip_mesh
            return host_chip_mesh(1)
        devices = local_devices()
    return Mesh(list(devices), (ENSEMBLE_AXIS,))


def ensemble_size(mesh):
    """Entries of the mesh's ensemble axis."""
    return mesh.shape[ENSEMBLE_AXIS]


def pad_batch(arr, multiple):
    """Pad the leading axis up to a multiple (repeating the last row) so it
    splits evenly; returns ``(padded, original_size)``."""
    n = arr.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    return torch.cat([arr, arr[-1:].expand((rem,) + tuple(arr.shape[1:]))]), n


def shard_ensemble(arr, mesh=None):
    """Split an ensemble array (a tensor or an array, batch first) into the
    mesh's contiguous shards, padding the batch to a multiple of the
    ensemble axis.  Returns ``(shards, original_size)``: this process's
    shards, each contiguous on the first device of its entry's group.  In a
    multi-process run every process passes the same full array."""
    if mesh is None:
        mesh = ensemble_mesh()
    arr = arr if torch.is_tensor(arr) else torch.as_tensor(np.asarray(arr))
    padded, n = pad_batch(arr, ensemble_size(mesh))
    size = padded.shape[0] // ensemble_size(mesh)
    first = int(np.flatnonzero(mesh.processes.reshape(
        ensemble_size(mesh), -1)[:, 0] == process_rank())[0])
    return [padded[(first + k) * size:(first + k + 1) * size]
            .to(group[0]).contiguous()
            for k, group in enumerate(mesh.local_groups())], n


def gather_ensemble(shards, mesh, n, dim=0):
    """The inverse of :func:`shard_ensemble`: the shards (tensors, or
    tuples of them part by part) concatenated along ``dim`` on the first
    device of this process's first entry, all-gathered across processes
    where the mesh spans several, and cut back to the original size
    ``n``.  A part that is not a tensor (record times, the same in every
    shard) is the first shard's."""
    if isinstance(shards[0], tuple):
        return tuple(gather_ensemble(list(part), mesh, n, dim)
                     for part in zip(*shards))
    if not torch.is_tensor(shards[0]):
        return shards[0]
    home = mesh.local_groups()[0][0]
    block = torch.cat([s.to(home) for s in shards], dim=dim)
    if mesh.spans_processes():
        from qgs_tpu_torch.parallel.distributed import all_gather_blocks
        block = all_gather_blocks(block, dim)
    return block.narrow(dim, 0, n)


def map_shards(mesh, y, fns, run, dim=0):
    """``run`` over the ensemble ``y`` (a tensor, or a tuple of tensors
    sharing the batch axis), split over the mesh when ``B >=
    ensemble_size(mesh) > 1``.

    ``run(fns_k, ys)`` gets this process's shards ``ys`` and, for each,
    ``fns`` (a function or a tuple of them) on its device
    (:meth:`Mesh.replica`), and returns each shard's output; those are
    gathered along ``dim`` (:func:`gather_ensemble`) and cut back to B.
    Without a mesh, or a batch that does not fill it, ``run([fns], [y])``
    runs ``y`` whole on its own device."""
    B = (y[0] if isinstance(y, tuple) else y).shape[0]
    if mesh is None or not B >= ensemble_size(mesh) > 1:
        return run([fns], [y])[0]
    parts = [shard_ensemble(p, mesh)[0]
             for p in (y if isinstance(y, tuple) else (y,))]
    ys = [tuple(s) if isinstance(y, tuple) else s[0] for s in zip(*parts)]
    devices = [group[0] for group in mesh.local_groups()]
    if isinstance(fns, tuple):
        reps = [tuple(mesh.replica(g, d) for g in fns) for d in devices]
    else:
        reps = [mesh.replica(fns, d) for d in devices]
    return gather_ensemble(run(reps, ys), mesh, B, dim=dim)
