"""Process ranks for LTFB and production runs (``repro.launch.mesh``, and
the spawner half of ``repro.launch.distributed``).

JAX lays its devices out as a ``Mesh``; the port lays out process ranks
of ``torch.distributed``, one rank a device.  A grid's ranks are numbered
row-major, as JAX reshapes its device list: in the LTFB grid
``('trainer', 'model')`` rank ``t * per_trainer_model + m`` is trainer
``t``'s model shard ``m``.  The ``make_*`` functions build one process
group for every line of the grid along each axis (every rank takes part
in creating every group, as ``torch.distributed.new_group`` requires) and
keep the groups this rank belongs to; the ``*_layout`` functions compute
the grid alone, with no process group.

:func:`init_ranks` joins a job launched by ``torchrun`` or by
:func:`spawn` (it reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``).  Its backend is ``nccl`` on
``cuda`` and ``gloo`` on ``cpu`` unless the caller names one; ``gloo`` on
``cuda`` is taken only when asked for (the exchange then stages its
buffers through pinned host memory), and ``nccl`` is never swapped for
``gloo``: with more ranks on a host than it has cards, or on the CPU,
``nccl`` raises :class:`RankLayoutError` before any process group
exists.  Every collective waits at most the given timeout, so a dead or
stalled peer makes the survivors raise instead of hanging.

:func:`spawn` launches K copies of a command with that environment set
and supervises them: the first worker to fail takes the others down, and
the job's exit status is the workers'.
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device

# seconds a collective or a point-to-point exchange waits for its peers
DEFAULT_TIMEOUT_S = 300.0


class RankLayoutError(RuntimeError):
    """The ranks cannot be laid out as asked (raised before any process
    group is created)."""


# ---------------------------------------------------------------------------
# grids of ranks
# ---------------------------------------------------------------------------


@dataclass
class RankMesh:
    """A grid of global ranks with named axes.

    ``ranks[c]`` is the global rank at coordinate ``c``; ``groups[axis]``
    is the process group of this rank's line along ``axis`` (empty for a
    layout alone, or for a rank outside the grid).
    """

    axes: Tuple[str, ...]
    ranks: np.ndarray
    groups: Dict[str, object] = field(default_factory=dict)

    @property
    def shape(self) -> Tuple[int, ...]:
        """The grid's extent along each axis."""
        return tuple(self.ranks.shape)

    @property
    def size(self) -> int:
        """The number of ranks in the grid."""
        return int(self.ranks.size)

    def coords(self, rank: int) -> Tuple[int, ...]:
        """Grid coordinates of global ``rank``."""
        hit = np.argwhere(self.ranks == rank)
        if not len(hit):
            raise ValueError(f"rank {rank} is not in the {self.shape} grid")
        return tuple(int(c) for c in hit[0])

    def lines(self, axis: str) -> List[List[int]]:
        """The global ranks of every line along ``axis``, in the order
        their groups are created."""
        ax = self.axes.index(axis)
        moved = np.moveaxis(self.ranks, ax, -1)
        return [[int(r) for r in row]
                for row in moved.reshape(-1, self.ranks.shape[ax])]

    def line(self, axis: str, rank: int) -> List[int]:
        """The global ranks of ``rank``'s line along ``axis``."""
        return next(ln for ln in self.lines(axis) if rank in ln)


def layout(shape: Sequence[int], axes: Sequence[str],
           world: Optional[int] = None) -> RankMesh:
    """The grid of ``shape`` over ranks ``0 .. prod(shape) - 1``, with no
    process group.  Raises when ``world`` ranks are too few."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} for axes {tuple(axes)}")
    n = int(np.prod(shape))
    if world is not None and world < n:
        raise RankLayoutError(f"need {n} ranks, have {world}")
    return RankMesh(tuple(axes), np.arange(n).reshape(tuple(shape)))


def ltfb_layout(trainers: int, per_trainer_model: int = 16,
                world: Optional[int] = None) -> RankMesh:
    """The LTFB population grid ``('trainer', 'model')``."""
    return layout((trainers, per_trainer_model), ("trainer", "model"), world)


def production_layout(multi_pod: bool = False,
                      world: Optional[int] = None) -> RankMesh:
    """16 x 16 = 256 ranks ``('data', 'model')``, or 2 x 16 x 16 = 512
    ranks ``('pod', 'data', 'model')``."""
    if multi_pod:
        return layout((2, 16, 16), ("pod", "data", "model"), world)
    return layout((16, 16), ("data", "model"), world)


def host_layout(world: int, axes: Sequence[str] = ("data",)) -> RankMesh:
    """Every rank on the first axis, the others of size 1."""
    return layout((world,) + (1,) * (len(axes) - 1), axes, world)


def world_size() -> int:
    """Ranks in the default group (1 when no process group exists)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def build_groups(mesh: RankMesh, axes: Optional[Sequence[str]] = None,
                 timeout_s: Optional[float] = None) -> RankMesh:
    """Create a process group for every line of ``mesh`` along each axis
    (``axes``: only those) and keep this rank's; a collective: every rank
    of the default group calls it with the same mesh.  A line of every
    rank reuses the default group, unless ``timeout_s`` is given: then
    every group is new (the default group's backend), each collective on
    it waiting at most ``timeout_s``."""
    if not dist.is_initialized():
        raise RankLayoutError(
            "no process group: call init_ranks() first (launch with "
            "torchrun or repro_torch.launch.mesh.spawn)")
    layout(mesh.shape, mesh.axes, dist.get_world_size())
    me = dist.get_rank()
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s),
        "backend": dist.get_backend()}
    for axis in (mesh.axes if axes is None else axes):
        for ranks in mesh.lines(axis):
            if ranks == list(range(dist.get_world_size())) and not kw:
                group = dist.group.WORLD
            else:
                group = dist.new_group(ranks, **kw)
            if me in ranks:
                mesh.groups[axis] = group
    return mesh


def serve_layout(model: int, world: Optional[int] = None) -> RankMesh:
    """The serving grid ``('replica', 'model')``: ``world / model``
    replicas of ``model`` ranks each, a replica's model ranks adjacent
    (rank ``r * model + m`` is replica ``r``'s model rank ``m``)."""
    world = world_size() if world is None else world
    if model < 1 or world % model:
        raise RankLayoutError(f"{world} ranks do not split into replicas "
                              f"of {model} model ranks")
    return layout((world // model, model), ("replica", "model"), world)


def make_serve_mesh(model: int,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> RankMesh:
    """The serving grid with a model group per replica (the default
    group's backend: ``gloo`` for ranks sharing a card or on the CPU,
    ``nccl`` for a card a rank), each collective on it waiting at most
    ``timeout_s``, so a dead model peer makes the survivors raise."""
    return build_groups(serve_layout(model, world_size()), axes=("model",),
                        timeout_s=timeout_s)


def make_ltfb_mesh(trainers: int, per_trainer_model: int = 16) -> RankMesh:
    """The LTFB population grid with its process groups: one trainer
    group per model index, one model group per trainer."""
    return build_groups(ltfb_layout(trainers, per_trainer_model,
                                    world_size()))


def make_production_mesh(*, multi_pod: bool = False) -> RankMesh:
    """The production grid with its process groups (256 or 512 ranks)."""
    return build_groups(production_layout(multi_pod, world_size()))


def make_host_mesh(axes: Sequence[str] = ("data",)) -> RankMesh:
    """Every rank of the job on the first axis, with its groups."""
    return build_groups(host_layout(world_size(), axes))


# ---------------------------------------------------------------------------
# joining a job
# ---------------------------------------------------------------------------


@dataclass
class Ranks:
    """This process's place in the job."""

    rank: int
    world: int
    local_rank: int
    device: torch.device
    backend: str


def _env_int(name: str, default: Optional[int] = None) -> int:
    val = os.environ.get(name)
    if val is None:
        if default is None:
            raise RankLayoutError(
                f"{name} is not set: launch the ranks with torchrun or "
                "repro_torch.launch.mesh.spawn")
        return default
    return int(val)


def world_env() -> int:
    """``WORLD_SIZE`` of a launched job (1 when unset)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def launched() -> bool:
    """Whether this process was started as a rank (``RANK`` and
    ``WORLD_SIZE`` in its environment)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def choose_backend(dist_backend: Optional[str], device: str,
                   local_ranks: int, cards: int) -> str:
    """The process-group backend for ``device``: ``nccl`` on ``cuda`` and
    ``gloo`` on ``cpu`` unless ``dist_backend`` names one.  ``nccl`` on
    the CPU, or with more ranks on this host than cards, raises
    :class:`RankLayoutError` (it is never replaced by ``gloo``)."""
    kind = torch.device(device).type
    backend = dist_backend or ("nccl" if kind == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown dist backend {backend!r}")
    if backend == "nccl" and kind != "cuda":
        raise RankLayoutError(
            "--dist-backend nccl needs --device cuda (use gloo on the CPU)")
    if backend == "nccl" and local_ranks > cards:
        raise RankLayoutError(
            f"--dist-backend nccl puts one rank on a card, and {local_ranks} "
            f"ranks share this host's {cards} card(s); NCCL refuses two "
            "ranks on one device — pass --dist-backend gloo to share a card "
            "through host memory, or run fewer ranks")
    return backend


def init_ranks(dist_backend: Optional[str] = None, device: str = "cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Ranks:
    """Join the job this process was launched into and pin its device
    (``cuda:LOCAL_RANK % device_count`` on ``cuda``).

    Reads torchrun's environment; the process group waits at most
    ``timeout_s`` for any collective.  Idempotent: a second call returns
    the same place without creating another group.
    """
    rank, world = _env_int("RANK"), _env_int("WORLD_SIZE")
    local_rank = _env_int("LOCAL_RANK", rank)
    local_ranks = _env_int("LOCAL_WORLD_SIZE", world)
    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(dist_backend, dev.type, local_ranks, cards)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method="env://", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    return Ranks(rank, world, local_rank, dev, dist.get_backend())


# ---------------------------------------------------------------------------
# launching a job
# ---------------------------------------------------------------------------


def find_free_port(host: str = "127.0.0.1") -> int:
    """Bind port 0, return the OS-assigned free port."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int,
             base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment of rank ``rank`` of a ``world``-rank job on this
    host (torchrun's variables), with this package importable."""
    env = dict(os.environ if base is None else base)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    return env


def start(argv: Sequence[str], n: int,
          env: Optional[Dict[str, str]] = None,
          stdout=None, stderr=None) -> List[subprocess.Popen]:
    """Start ``n`` ranks of ``argv`` on a fresh port of this host; each
    rank's standard streams go to ``stdout(rank)`` / ``stderr(rank)``
    when given (callables returning a file or ``None``)."""
    port = find_free_port()
    return [subprocess.Popen(
        list(argv), env=rank_env(rank, n, port, env),
        stdout=stdout(rank) if stdout else None,
        stderr=stderr(rank) if stderr else None) for rank in range(n)]


def supervise(procs: List[subprocess.Popen],
              timeout: Optional[float] = None) -> int:
    """Wait for every rank; the first nonzero exit kills the others (a
    dead rank stalls its peers at the next collective, so waiting out
    their timeout proves nothing).  Returns the first failure's exit code,
    or 0.  With ``timeout`` a job still running after that many seconds
    is killed and ``TimeoutError`` raised."""
    deadline = None if timeout is None else time.monotonic() + timeout
    status = 0
    try:
        live = list(procs)
        while live:
            for p in list(live):
                rc = p.poll()
                if rc is None:
                    continue
                live.remove(p)
                if rc != 0 and status == 0:
                    status = rc
                    for q in live:
                        q.terminate()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{len(live)} of {len(procs)} ranks still running "
                    f"after {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return status


def spawn(argv: Sequence[str], n: int,
          env: Optional[Dict[str, str]] = None,
          timeout: Optional[float] = None) -> int:
    """Launch ``n`` ranks of ``argv`` and supervise them
    (:func:`start`, :func:`supervise`); returns the job's exit status."""
    return supervise(start(argv, n, env), timeout)
