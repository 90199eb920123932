"""The 1-D data mesh of the shard engine, on ``torch.distributed``
(PyTorch port of the data-mesh half of ``repro/launch/mesh.py``).

The reference's data mesh is one controller's view of S devices; here a
mesh is one rank of a process group, each rank a process driving one
device.  :class:`DataMesh` holds the group, the rank, the world size, the
rank's device and the axis name (``"data"``), and runs the engine's
collectives on the device's backend: NCCL for CUDA tensors, gloo for CPU
ones (the default group is made with both, ``"cpu:gloo,cuda:nccl"``,
where NCCL is available).  A CUDA mesh whose group has no NCCL backend is
refused: there is no silent gloo on the card.

Rendezvous is a ``torch.distributed.FileStore`` in a temporary directory,
so no socket is opened for it:

  * in one process, :func:`make_data_mesh` makes a world-size-1 group
    itself (a real process group: the collectives run as on S ranks);
  * for S ranks, each process calls :func:`init_ranks` with its rank, the
    world size and one store path shared by all, then
    :func:`make_data_mesh`.  A launcher that made the default group
    already (``torchrun``) is used as it is.

Every collective the mesh issues is counted in ``issued`` and
``issued_bytes`` (the engine's own accounting is the reference's, in
:mod:`repro_torch.shard.telemetry`).  The mesh warms its communicator
with one all-reduce when it is built, so NCCL's lazy set-up does not land
inside the first outer iteration.

The LM substrate's meshes are ``torch.distributed.device_mesh.DeviceMesh``es
over the default group:

  * **production meshes** (:func:`make_production_mesh`): (data=16,
    model=16) = 256 ranks, or (pod=2, data=16, model=16) = 512.  DP runs
    over ('pod', 'data'), TP/EP over 'model', FSDP maps 'embed' onto
    'data' (``repro_torch.models.common.DEFAULT_RULES``).  The dry-run
    (:mod:`repro_torch.launch.dryrun`) builds them over a *fake* process
    group of that world size in one process
    (:func:`force_host_platform_device_count`), where nothing runs;
  * the **host mesh** (:func:`make_host_mesh`): 1 x 1 ('data', 'model') on
    this rank's device.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"


def _backend_string() -> str:
    """The default group's backends: gloo for CPU tensors, and NCCL for
    CUDA tensors where this PyTorch has it."""
    return "cpu:gloo,cuda:nccl" if dist.is_nccl_available() else "gloo"


def init_ranks(rank: int, world_size: int, store_path: str) -> None:
    """Make this process rank ``rank`` of a ``world_size``-rank default
    group, through a ``FileStore`` at ``store_path`` (one path shared by
    every rank, on a file system they all see).  Call once per process,
    before :func:`make_data_mesh`."""
    if dist.is_initialized():
        raise RuntimeError("init_ranks: this process already belongs to a "
                           "process group")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    store = dist.FileStore(str(store_path), int(world_size))
    dist.init_process_group(_backend_string(), store=store, rank=int(rank),
                            world_size=int(world_size))


def _ensure_group() -> None:
    """The default group; a world-size-1 one in this process when none
    exists yet."""
    if dist.is_initialized():
        return
    path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_mesh_"),
                        "store")
    init_ranks(0, 1, path)


class DataMesh:
    """One rank's view of the 1-D data mesh: the process group, this
    rank's index and device, the world size and the axis name.

    The engine's collectives go through :meth:`all_reduce` (a sum, in
    place) and :meth:`all_gather`; each is counted in ``issued`` and its
    payload in ``issued_bytes``."""

    def __init__(self, group, device: torch.device, axis: str = DATA_AXIS):
        self.group = group
        self.device = torch.device(device)
        self.axis = axis
        self.axis_names = (axis,)
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.issued = 0
        self.issued_bytes = 0

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as a reference mesh's ``shape``."""
        return {self.axis: self.size}

    @property
    def backend(self) -> str:
        """The backend the mesh's device runs collectives on."""
        return "nccl" if self.device.type == "cuda" else "gloo"

    def _count(self, t: torch.Tensor) -> None:
        self.issued += 1
        self.issued_bytes += t.numel() * t.element_size()

    def _check(self, t: torch.Tensor) -> None:
        if t.device != self.device:
            raise ValueError(f"DataMesh on {self.device} got a tensor on "
                             f"{t.device}")

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place (every rank gets the same
        sum); returns ``t``.  On CUDA nothing waits for the device."""
        self._check(t)
        self._count(t)
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked along a new leading rank axis:
        ``(size, *t.shape)``, the same on every rank."""
        self._check(t)
        self._count(t)
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return torch.stack(out)

    def barrier(self) -> None:
        """Wait until every rank reaches this point (host side)."""
        if self.size > 1:
            dist.barrier(group=self.group)

    def __repr__(self) -> str:
        return (f"DataMesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, axis={self.axis!r})")


def validate_mesh(mesh, required_axes: Sequence[str]) -> None:
    """Check a mesh's axis names and its device against its backend: the
    required named axes exist, and a CUDA mesh's group runs NCCL.  A
    ``DeviceMesh`` is checked for its axis names, each rank once and its
    device type (CUDA or CPU)."""
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(mesh, DeviceMesh):
        names = mesh.mesh_dim_names or ()
        missing = [a for a in required_axes if a not in names]
        if missing:
            raise ValueError(
                f"mesh axes {names} are missing required {missing}")
        ranks = mesh.mesh.flatten().tolist()
        if len(set(ranks)) != len(ranks):
            raise ValueError("mesh contains duplicate ranks")
        if mesh.device_type not in ("cuda", "cpu"):
            raise ValueError(f"mesh on unsupported device "
                             f"{mesh.device_type}")
        return
    missing = [a for a in required_axes if a not in mesh.axis_names]
    if missing:
        raise ValueError(
            f"mesh axes {mesh.axis_names} are missing required {missing}")
    if mesh.device.type == "cuda" and (
            not dist.is_nccl_available()
            or "nccl" not in str(dist.get_backend(mesh.group))):
        raise ValueError(f"mesh on {mesh.device}, but its process group "
                         f"({dist.get_backend(mesh.group)}) has no NCCL "
                         "backend for its collectives")
    if mesh.device.type not in ("cuda", "cpu"):
        raise ValueError(f"mesh on unsupported device {mesh.device}")


def make_data_mesh(n_devices: Optional[int] = None, *,
                   axis: str = DATA_AXIS,
                   device: Union[str, torch.device, None] = None
                   ) -> DataMesh:
    """The 1-D block-sharding mesh this rank runs on.

    Uses the default process group (made by :func:`init_ranks` or a
    launcher), or makes a world-size-1 group in this process.
    ``n_devices``, when given, must equal the world size.  ``device``
    defaults to this rank's CUDA device (``cuda:<local rank mod the
    card count>``); pass ``"cpu"`` for a gloo mesh.  The communicator is
    warmed with one all-reduce.
    """
    _ensure_group()
    size = dist.get_world_size()
    n = size if n_devices is None else int(n_devices)
    if n != size:
        raise ValueError(
            f"requested {n} devices, have {size} rank(s) (hint: start {n} "
            "processes and call launch.mesh.init_ranks in each)")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_data_mesh: no CUDA device; pass "
                               "device='cpu' for a CPU mesh")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = DataMesh(dist.group.WORLD, device, axis)
    validate_mesh(mesh, (axis,))
    warm = torch.zeros((1,), dtype=torch.float32, device=device)
    dist.all_reduce(warm, group=mesh.group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return mesh


def ensure_data_mesh(mesh: Optional[DataMesh] = None, *,
                     axis: str = DATA_AXIS,
                     device: Union[str, torch.device, None] = None
                     ) -> DataMesh:
    """Resolve an optional mesh knob to a validated 1-D data mesh: None
    builds :func:`make_data_mesh` on ``device`` (the engines pass the
    problem's); a given mesh is validated to carry ``axis`` and returned
    as it is.  The ``RunConfig.mesh`` resolution of the ``mpbcfw-shard*``
    engines."""
    if mesh is None:
        return make_data_mesh(axis=axis, device=device)
    if not isinstance(mesh, DataMesh):
        raise ValueError(f"RunConfig.mesh must be a repro_torch DataMesh "
                         f"(launch.mesh.make_data_mesh), got {mesh!r}")
    validate_mesh(mesh, (axis,))
    return mesh


# ---------------------------------------------------------------------------
# The LM substrate's meshes


def force_host_platform_device_count(n: int) -> bool:
    """Make this process rank 0 of a *fake* process group of world size
    ``n`` (``torch.testing._internal.distributed.fake_pg``: its
    collectives return at once and move nothing), so that the production
    meshes can be built for the dry-run on one host.  The torch
    counterpart of the reference's helper of that name.

    Returns True if the group was made, False if a default group of
    exactly ``n`` ranks exists already; raises RuntimeError when one of
    another size does (start a fresh process), as the reference raises
    once jax is initialized."""
    if n < 1:
        raise ValueError(f"device count must be >= 1, got {n}")
    if dist.is_initialized():
        have = dist.get_world_size()
        if have == n:
            return False
        raise RuntimeError(
            f"a process group of {have} rank(s) exists already; a fake "
            f"group of {n} must be made before any other (start a fresh "
            "process, call this helper first)")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(n))
    return True


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ('data', 'model'), or (2, 16, 16) ('pod', 'data',
    'model') with ``multi_pod``, over the default group (256 or 512 ranks:
    the dry-run's fake one, whose tensors are CPU tensors, so a CPU
    mesh)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    validate_mesh(mesh, axes)
    return mesh


def make_host_mesh(device: Union[str, torch.device, None] = None):
    """The degenerate 1 x 1 ('data', 'model') mesh on this process's
    device: CUDA unless ``device="cpu"``.  Over the default group, or a
    world-size-1 ``FileStore`` group made here (as :func:`make_data_mesh`),
    which stays for the process."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh: no CUDA device; pass "
                           "device='cpu' for a CPU mesh")
    _ensure_group()
    if dist.get_world_size() != 1:
        raise RuntimeError(f"make_host_mesh: the default group has "
                           f"{dist.get_world_size()} ranks, not 1")
    mesh = DeviceMesh(dev.type, [[0]], mesh_dim_names=("data", "model"))
    validate_mesh(mesh, ("data", "model"))
    return mesh
