"""The communication frontend, on ``torch.distributed``.

Counterpart of ``deepspeed_tpu/comm/comm.py``: the same module-level API
(``init_distributed``, ``ReduceOp``, ``all_reduce`` ... ``barrier``,
``log_summary``), where a "group" is a mesh axis name or a tuple of names
of the current :class:`~deepspeed_tpu_torch.parallel.topology.MeshTopology`.
A single axis resolves to the ``DeviceMesh``'s process group for that axis,
a tuple such as ``("fsdp", "data")`` to a flattened group whose ranks are
ordered with the first axis major (as a PartitionSpec entry orders them),
``None`` to the whole world.

Calling convention: the JAX functions run inside ``shard_map`` (or, as
``eager_*``, on stacked per-rank arrays in one process). Here every rank is
a process and passes its own tensor: ``all_reduce(t, group="fsdp")`` on
rank r is what ``eager_all_reduce(stacked, group="fsdp")[r]`` gives in the
JAX package. Each function returns its result (``all_reduce``,
``broadcast`` and ``all_gather_into_tensor``/``reduce_scatter_tensor`` with
an ``output`` also write in place).

Backends: ``nccl`` for CUDA tensors, ``gloo`` for the CPU. ``gloo`` with
CUDA tensors (several ranks sharing one card, where NCCL refuses duplicate
GPUs) stages every payload through host memory in :func:`_on_backend`, and
``comms_logger.host_staged_bytes`` counts those bytes. Under gloo an
all-gather runs as one broadcast a member, which moves its bytes faster
there than gloo's own allgather (``PERF.md`` section 6, PR 18).
"""

from __future__ import annotations

import functools
import os
import time
from datetime import timedelta
from enum import Enum
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from ..parallel import topology as topo
from ..utils.comms_logging import CommsLogger, get_msg_size_from_args
from ..utils.logging import logger

Group = Union[str, Sequence[str], None]

comms_logger = CommsLogger()

_initialized = False
_backend: Optional[str] = None
_groups: dict = {}


class ReduceOp(Enum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    AVG = 4
    BAND = 5
    BOR = 6
    BXOR = 7
    UNUSED = 8


# the single-tensor collectives' newer names, where this torch has them
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor

_TORCH_OPS = {ReduceOp.SUM: "SUM", ReduceOp.AVG: "SUM",
              ReduceOp.PRODUCT: "PRODUCT", ReduceOp.MIN: "MIN",
              ReduceOp.MAX: "MAX"}


# --------------------------------------------------------------------------
# init / world info
# --------------------------------------------------------------------------

def _discover(rank: int, world_size: int, auto_mpi_discovery: bool,
              distributed_port: int):
    """(coordinator address or None, rank, world size) from the launch
    environment, as the JAX package reads it."""
    coord = os.environ.get("COORDINATOR_ADDRESS")
    if coord is None and os.environ.get("MASTER_ADDR"):
        coord = (f"{os.environ['MASTER_ADDR']}:"
                 f"{os.environ.get('MASTER_PORT', distributed_port)}")
    if world_size < 0:
        world_size = int(os.environ.get(
            "WORLD_SIZE", os.environ.get("NUM_PROCESSES", "-1")))
    if rank < 0:
        rank = int(os.environ.get("RANK", os.environ.get("PROCESS_ID", "-1")))
    mpi_launched = False
    if auto_mpi_discovery and (rank < 0 or world_size < 0):
        # mpirun (OpenMPI) / PMI (MPICH, srun) launch conventions
        mpi_rank = os.environ.get("OMPI_COMM_WORLD_RANK",
                                  os.environ.get("PMI_RANK"))
        mpi_world = os.environ.get("OMPI_COMM_WORLD_SIZE",
                                   os.environ.get("PMI_SIZE"))
        mpi_launched = mpi_rank is not None
        if rank < 0 and mpi_rank is not None:
            rank = int(mpi_rank)
        if world_size < 0 and mpi_world is not None:
            world_size = int(mpi_world)
    if world_size < 0:
        world_size = 1
    if rank < 0:
        rank = 0
    if world_size > 1 and coord is None and mpi_launched:
        # mpirun sets no MASTER_ADDR: broadcast rank 0's address over MPI
        # when mpi4py exists, else fail loudly (a silent single-process
        # fallback would train divergent replicas)
        try:
            from mpi4py import MPI  # type: ignore
        except ImportError:
            raise ValueError(
                f"MPI-launched job (rank {rank}/{world_size}) has no "
                "COORDINATOR_ADDRESS/MASTER_ADDR and mpi4py is not "
                "available to broadcast one — export MASTER_ADDR=<rank0 "
                "host> in the mpirun command") from None
        from ..serving.fabric.transport import _routable_ip

        addr = MPI.COMM_WORLD.bcast(_routable_ip() if rank == 0 else None,
                                    root=0)
        coord = f"{addr}:{distributed_port}"
    return coord, rank, world_size


def init_distributed(dist_backend: Optional[str] = None,
                     auto_mpi_discovery: bool = True,
                     distributed_port: int = 29500,
                     verbose: bool = True,
                     timeout=None,
                     init_method: Optional[str] = None,
                     dist_init_required: Optional[bool] = None,
                     config=None,
                     rank: int = -1,
                     world_size: int = -1,
                     device: Optional[str] = None) -> None:
    """Bring up the default process group for a multi-process job.

    Environment contract (the JAX package's): ``COORDINATOR_ADDRESS`` or
    ``MASTER_ADDR:MASTER_PORT``, ``RANK``/``PROCESS_ID``,
    ``WORLD_SIZE``/``NUM_PROCESSES``, and with ``auto_mpi_discovery`` the
    OpenMPI/PMI variables. ``init_method`` (e.g. ``file://...``) overrides
    the address, and with it a one-rank world gets a process group too.
    ``dist_backend`` defaults to ``nccl`` on ``device="cuda"`` (the default
    when CUDA is present) and ``gloo`` on ``device="cpu"``. A process group
    someone else brought up is adopted as it is.
    """
    global _initialized, _backend
    if config is not None:
        comms_logger.configure(config.comms_logger)
    if _initialized:
        return
    if dist.is_available() and dist.is_initialized():
        _backend = dist.get_backend()
        _initialized = True
        return
    coord, rank, world_size = _discover(rank, world_size, auto_mpi_discovery,
                                        distributed_port)
    if world_size <= 1 and init_method is None:
        return                  # one process: no rendezvous
    if init_method is None:
        if coord is None:
            raise ValueError(
                f"WORLD_SIZE={world_size} but no COORDINATOR_ADDRESS/"
                "MASTER_ADDR and no init_method: the ranks cannot meet")
        init_method = f"tcp://{coord}"
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    backend = dist_backend or ("nccl" if torch.device(device).type == "cuda"
                               else "gloo")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if backend == "nccl":
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        if local_world > torch.cuda.device_count():
            raise ValueError(
                f"nccl with {local_world} ranks on this host and "
                f"{torch.cuda.device_count()} GPU(s): NCCL refuses two ranks "
                "on one GPU; use dist_backend='gloo' to share a card")
        torch.cuda.set_device(local_rank)
    if verbose:
        logger.info(f"Initializing torch.distributed: backend={backend} "
                    f"init_method={init_method} rank={rank}/{world_size}")
    kw = {}
    if timeout is not None:
        kw["timeout"] = (timeout if isinstance(timeout, timedelta)
                         else timedelta(seconds=float(timeout)))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    _backend = backend
    _initialized = True


def destroy_distributed() -> None:
    """Tear down the default process group, the cached groups and the
    topology registry (a test's or a child process's last call)."""
    global _initialized, _backend
    _groups.clear()
    _pinned.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    topo.reset_topology()
    _initialized = False
    _backend = None


def is_initialized() -> bool:
    return _initialized or (dist.is_available() and dist.is_initialized())


def _up() -> bool:
    return dist.is_available() and dist.is_initialized()


def _axes(group: Group):
    if group is None:
        return tuple(topo.get_topology().axis_names)
    return (group,) if isinstance(group, str) else tuple(group)


def _live_axes(group: Group):
    t = topo.get_topology()
    return tuple(a for a in _axes(group) if t.axis_size(a) > 1)


def _process_group(group: Group):
    """The process group of ``group``'s axes (axes of size 1 dropped), or
    None for a group of one rank."""
    axes = _live_axes(group)
    t = topo.get_topology()
    if not axes:
        # a one-rank world still has its process group (its backend runs)
        return dist.group.WORLD if _up() and dist.get_world_size() == 1 \
            else None
    key = (t.axis_order, tuple(t.shape.values()), axes)
    if key in _groups:
        return _groups[key]
    if t.world_size != dist.get_world_size():
        raise ValueError(f"topology {t} spans {t.world_size} ranks, the "
                         f"process group {dist.get_world_size()}")
    live_order = tuple(a for a in t.axis_order if t.axis_size(a) > 1)
    if axes == live_order:
        pg = dist.group.WORLD
    elif len(axes) == 1:
        device_type = "cuda" if _backend == "nccl" else "cpu"
        pg = t.device_mesh(device_type).get_group(axes[0])
    else:
        # a flattened group: every rank makes every group of the
        # enumeration, in the same order
        pg, _ = dist.new_subgroups_by_enumeration(t.group_ranks(axes))
    _groups[key] = pg
    return pg


def _pg(group: Group):
    """The process group a collective over ``group`` runs on, or None when
    no process group is up (a one-rank group computes locally)."""
    if not _up():
        if get_world_size(group) > 1:
            raise RuntimeError(f"a collective over {group!r} of "
                               f"{get_world_size(group)} ranks needs a "
                               "process group (init_distributed)")
        return None
    return _process_group(group)


def _members(group: Group) -> list:
    """The global ranks of this rank's group, in flat order (the first axis
    major)."""
    me = get_rank()
    return next(g for g in topo.get_topology().group_ranks(_live_axes(group))
                if me in g)


def _pg_positions(group: Group):
    """For each member of this rank's group in flat order, its position in
    the process group, which orders its ranks by global rank; None where
    the two orders agree."""
    flat = _members(group)
    by_rank = sorted(flat)
    return None if flat == by_rank else [by_rank.index(r) for r in flat]


def get_rank(group: Group = None) -> int:
    """This process's rank; with ``group``, its index in the group."""
    if group is not None:
        return axis_index(group)
    return dist.get_rank() if _up() else 0


def get_world_size(group: Group = None) -> int:
    """Size of ``group`` (mesh axis/axes); None = the whole mesh."""
    t = topo.get_topology()
    if group is None:
        return t.world_size
    return t.axis_size_of(_axes(group))


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def axis_index(group: Group = None) -> int:
    """This rank's index in ``group`` (the first axis major)."""
    return topo.get_topology().flat_index(get_rank(), _axes(group))


def barrier(group: Group = None) -> None:
    """Wait for every rank of ``group``; in one process, wait for the
    card's outstanding work."""
    pg = _pg(group)
    if pg is not None:
        if _backend == "nccl":
            dist.barrier(group=pg, device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group=pg)
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# --------------------------------------------------------------------------
# the backend call
# --------------------------------------------------------------------------

_pinned: dict = {}


def _host_buffer(t: torch.Tensor, slot: int) -> torch.Tensor:
    """A page-locked host tensor of ``t``'s shape and dtype, reused by
    every call of that size (``slot`` keeps an input and an output of one
    size apart): a pageable copy runs at a fraction of the link's rate,
    and allocating page-locked memory each call costs more than the copy."""
    nbytes = t.numel() * t.element_size()
    key = (nbytes, slot)
    buf = _pinned.get(key)
    if buf is None:
        buf = _pinned[key] = torch.empty(nbytes, dtype=torch.uint8,
                                         pin_memory=True)
    return buf.view(t.dtype).view(t.shape)


def _on_backend(fn, out: torch.Tensor, *ins: torch.Tensor) -> torch.Tensor:
    """Run ``fn(out, *ins)``, a ``torch.distributed`` call that writes
    ``out``; with no ``ins`` it works on ``out`` in place. Under gloo, CUDA
    payloads go through page-locked host buffers: the inputs (or the
    in-place tensor) are copied to the host, the call runs there, and
    ``out`` is copied back. ``comms_logger`` counts the copied bytes in
    ``host_staged_bytes`` and their seconds in ``host_staged_s``."""
    if _backend != "gloo" or not any(t.is_cuda for t in (out,) + ins):
        fn(out, *ins)
        return out
    t0 = time.perf_counter()
    h_ins = [_host_buffer(t, 1 + i).copy_(t) for i, t in enumerate(ins)]
    h_out = _host_buffer(out, 0)
    if not ins:
        h_out.copy_(out)
    t1 = time.perf_counter()
    fn(h_out, *h_ins)
    t2 = time.perf_counter()
    out.copy_(h_out)
    torch.cuda.current_stream(out.device).synchronize()
    comms_logger.host_staged_s += t1 - t0 + time.perf_counter() - t2
    comms_logger.host_staged_bytes += (
        sum(t.numel() * t.element_size() for t in ins)
        + (1 if ins else 2) * out.numel() * out.element_size())
    return out


def _timed(op_name):
    """Time a collective through ``comms_logger`` when it profiles
    ``op_name``: the tensor's stream is synchronized before the clock is
    read and again after the call, so the time is the collective's."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not comms_logger.should_profile(op_name):
                return fn(*args, **kwargs)
            tensors = [a for a in args if torch.is_tensor(a)]
            cuda = [t for t in tensors if t.is_cuda]

            def sync():
                for t in cuda[:1]:
                    torch.cuda.current_stream(t.device).synchronize()

            sync()
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            sync()
            dt = time.perf_counter() - t0
            group = kwargs.get("group")
            if group is None:
                for a in reversed(args):
                    if isinstance(a, (str, tuple)):
                        group = a
                        break
            comms_logger.append(op_name, op_name, dt,
                                get_msg_size_from_args(*tensors),
                                get_world_size(group))
            return result
        return wrapper
    return deco


# --------------------------------------------------------------------------
# collectives: each rank passes its own tensor
# --------------------------------------------------------------------------

@_timed("all_reduce")
def all_reduce(tensor, op: ReduceOp = ReduceOp.SUM, group: Group = None):
    """Reduce ``tensor`` over ``group`` in place and return it (AVG is
    the sum divided by the group size, as in the JAX package)."""
    if op not in _TORCH_OPS:
        raise NotImplementedError(f"ReduceOp {op} is not supported")
    n = get_world_size(group)
    pg = _pg(group)
    if pg is not None:
        top = getattr(dist.ReduceOp, _TORCH_OPS[op])
        _on_backend(lambda o: dist.all_reduce(o, op=top, group=pg), tensor)
    if op == ReduceOp.AVG and n > 1:
        tensor.div_(n)
    return tensor


def inference_all_reduce(tensor, op: ReduceOp = ReduceOp.SUM,
                         group: Group = None):
    """The latency-optimized TP all-reduce: the same call here."""
    return all_reduce(tensor, op, group)


def _gather0(tensor, group):
    """``tensor`` of every rank of ``group`` concatenated along dim 0."""
    n = get_world_size(group)
    x = tensor.contiguous()
    pg = _pg(group)
    if pg is None:
        return x.clone()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    if _backend == "gloo":
        # gloo's allgather moves a byte slower than its broadcast between
        # ranks of one host (PERF.md, PR 18), so each member broadcasts its
        # block into its slot, in flat order
        def gather(o, i):
            for part, src in zip(o.chunk(n, dim=0), _members(group)):
                if src == get_rank():
                    part.copy_(i)
                dist.broadcast(part, src, group=pg)
        return _on_backend(gather, out, x)
    _on_backend(lambda o, i: _ALL_GATHER(o, i, group=pg), out, x)
    pos = _pg_positions(group)
    if pos is not None:
        parts = out.chunk(n, dim=0)
        out = torch.cat([parts[p] for p in pos], dim=0)
    return out


@_timed("all_gather_into_tensor")
def all_gather_into_tensor(output, tensor, group: Group = None,
                           axis: int = 0):
    """Every rank's ``tensor`` concatenated along ``axis`` in group order
    (written into ``output`` too when one is given)."""
    n = get_world_size(group)
    if axis == 0:
        out = _gather0(tensor, group)
    else:
        stacked = _gather0(tensor.movedim(axis, 0), group)
        out = torch.cat([c.movedim(0, axis)
                         for c in stacked.chunk(n, dim=0)], dim=axis)
    if output is not None:
        output.copy_(out)
        return output
    return out


@_timed("all_gather")
def all_gather(tensor_list, tensor, group: Group = None):
    """Every rank's ``tensor`` stacked on a new dim 0 ([group, ...]); a
    given ``tensor_list`` receives the pieces."""
    out = _gather0(tensor.unsqueeze(0), group)
    if tensor_list is not None:
        for dst, src in zip(tensor_list, out.unbind(0)):
            dst.copy_(src)
    return out


@_timed("reduce_scatter_tensor")
def reduce_scatter_tensor(output, tensor, op: ReduceOp = ReduceOp.SUM,
                          group: Group = None, scatter_dim: int = 0):
    """Sum ``tensor`` over ``group`` and keep this rank's equal chunk along
    ``scatter_dim`` (AVG divides by the group size)."""
    n = get_world_size(group)
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise NotImplementedError(f"reduce_scatter_tensor with {op}")
    pg = _pg(group)
    if pg is None:
        out = tensor.clone()
    else:
        x = tensor.movedim(scatter_dim, 0).contiguous()
        pos = _pg_positions(group)
        if pos is not None:      # chunk p goes to the group's p-th rank
            parts = x.chunk(n, dim=0)
            x = torch.cat([parts[pos.index(p)] for p in range(n)], dim=0)
        chunk = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                            dtype=x.dtype, device=x.device)
        _on_backend(lambda o, i: _REDUCE_SCATTER(o, i, group=pg),
                    chunk, x)
        out = chunk.movedim(0, scatter_dim)
        if op == ReduceOp.AVG:
            out = out / n
    if output is not None:
        output.copy_(out)
        return output
    return out


@_timed("all_to_all_single")
def all_to_all_single(output, tensor, group: Group = None,
                      split_axis: int = 0, concat_axis: int = 0):
    """Split ``tensor`` along ``split_axis`` into group-size chunks, send
    chunk i to the group's rank i, and concatenate the received chunks
    along ``concat_axis``."""
    if len(_axes(group)) != 1:
        raise ValueError("all_to_all_single requires a single mesh axis "
                         "group")
    n = get_world_size(group)
    pg = _pg(group)
    if pg is None:
        out = tensor.clone()
    else:
        x = tensor.movedim(split_axis, 0).contiguous()
        recv = torch.empty_like(x)
        _on_backend(lambda o, i: dist.all_to_all_single(o, i, group=pg),
                    recv, x)
        out = torch.cat([c.movedim(0, split_axis)
                         for c in recv.chunk(n, dim=0)], dim=concat_axis)
    if output is not None:
        output.copy_(out)
        return output
    return out


def _global_rank(group: Group, index: int) -> int:
    """The global rank of the group member at ``index``, in this rank's
    group."""
    t = topo.get_topology()
    me = get_rank()
    for ranks in t.group_ranks(_axes(group)):
        if me in ranks:
            return ranks[index]
    raise ValueError(f"rank {me} is in no group of {group}")


@_timed("broadcast")
def broadcast(tensor, src: int = 0, group: Group = None):
    """``tensor`` of the group's rank ``src`` on every rank of the group
    (in place; returned)."""
    pg = _pg(group)
    if pg is not None:
        root = _global_rank(group, src)
        _on_backend(lambda o: dist.broadcast(o, root, group=pg), tensor)
    return tensor


@_timed("ppermute")
def ppermute(tensor, perm, group: Group = None):
    """Each ``(src, dst)`` pair of group indices moves ``src``'s tensor to
    ``dst``; returns what this rank receives (zeros when it receives
    nothing)."""
    if len(_axes(group)) != 1:
        raise ValueError("ppermute requires a single mesh axis group")
    me = axis_index(group)
    received = torch.zeros_like(tensor)
    ops = []
    x = tensor.contiguous()
    staged = _backend == "gloo" and x.is_cuda
    hx = _host_buffer(x, 1).copy_(x) if staged else x
    hr = _host_buffer(received, 0).zero_() if staged else received
    got = False
    for s, d in perm:
        if s == me and d == me:
            hr.copy_(hx)
            got = True
            continue
        if s == me:
            ops.append(dist.P2POp(dist.isend, hx, _global_rank(group, d)))
        if d == me:
            ops.append(dist.P2POp(dist.irecv, hr, _global_rank(group, s)))
            got = True
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if staged and got:
        received.copy_(hr)
        comms_logger.host_staged_bytes += 2 * x.numel() * x.element_size()
    return received


def send(tensor, dst: int, src: int, group: Group = None):
    """Move ``src``'s tensor to ``dst`` (both group indices, as the JAX
    package names both); returns what this rank receives."""
    return ppermute(tensor, [(src, dst)], group)


def recv(tensor_shape_like, src: int, dst: int, group: Group = None):
    """The receiver's view of :func:`send`."""
    return ppermute(tensor_shape_like, [(src, dst)], group)


def reduce(tensor, dst: int, op: ReduceOp = ReduceOp.SUM, group: Group = None):
    """The reduction on the group's rank ``dst``, zeros elsewhere."""
    out = all_reduce(tensor.clone(), op, group)
    return out if axis_index(group) == dst else torch.zeros_like(out)


def log_summary(show_straggler: bool = False):
    """Dump the comms logger's summary."""
    return comms_logger.log_all(print_log=True, show_straggler=show_straggler)


# Capability probes — always true here.
def has_all_gather_into_tensor() -> bool:
    return True


def has_reduce_scatter_tensor() -> bool:
    return True


def has_coalescing_manager() -> bool:
    return True
