"""Multi-process data-parallel runtime on ``torch.distributed`` (counterpart
of ``rtvc_tpu/parallel/distributed.py`` and of the process helpers of
``rtvc_tpu/parallel/mesh.py``).

One process per device. Each process trains on its own rows of every global
batch, and the step (``train/steps.py``) makes the result the global step's:

  * parameters and buffers start equal on every rank (:func:`replicate_global`,
    a broadcast from rank 0);
  * the gradients are averaged over the ranks right after ``backward()``
    (:func:`average_gradients`), before any clip, so a norm is the global
    gradient's;
  * the GE2E loss reads the global (S, U, E) embeddings through an autograd
    all-gather (:func:`all_gather_rows`), as the JAX package's jitted global
    step does, not each rank's own similarity matrix;
  * the BatchNorms take the global batch's moments through a differentiable
    all-reduce (``models/layers.py:BatchNorm1d``);
  * a random mask is drawn at the global batch's shape from the step's
    generator, and each rank keeps its own rows (:class:`ShardRows`,
    :func:`uniform`), so two processes draw what one process draws.

Launch one process per device, with the launch flags of
:func:`add_launch_args` or the ``RTVC_COORDINATOR`` / ``RTVC_NUM_PROCESSES``
/ ``RTVC_PROCESS_ID`` environment::

    RTVC_COORDINATOR=host0:8476 RTVC_NUM_PROCESSES=4 RTVC_PROCESS_ID=k \\
        python -m rtvc_tpu_torch.encoder_train my_run datasets/SV2TTS/encoder

The process group is NCCL's when the process's device is a card and gloo's
on the CPU. The JAX package's several devices in one process (its 2 x 4
mesh) have no counterpart: a process here owns one device. Nothing falls
back: a failed rendezvous, a collective's error or a card asked for where
there is none raises.
"""
from __future__ import annotations

import os
from typing import Iterable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

COORD_ENV = "RTVC_COORDINATOR"
NPROC_ENV = "RTVC_NUM_PROCESSES"
PID_ENV = "RTVC_PROCESS_ID"

Tensor = torch.Tensor


def process_index() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes, 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def is_distributed() -> bool:
    return process_count() > 1


def wait_for_everyone() -> None:
    """A barrier over every process (nothing in one process)."""
    if is_distributed():
        dist.barrier()


def process_device(device=None, process_id: Optional[int] = None) -> torch.device:
    """The device of process ``process_id`` (this process's rank by
    default): ``None`` or a ``cuda`` without an index is card
    ``process_id % device_count``; any other device is taken as it is named.
    RuntimeError where a card is asked for and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a process of the group needs a card unless it "
                           "is given device='cpu'")
    if device.index is None:
        pid = process_index() if process_id is None else process_id
        device = torch.device("cuda", pid % torch.cuda.device_count())
    return device


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               device=None) -> dist.ProcessGroup:
    """Join the process group at ``tcp://<coordinator_address>`` (host:port of
    process 0) as rank ``process_id`` of ``num_processes``; each argument
    falls back to its ``RTVC_*`` environment variable. The backend is NCCL
    when this process's device (:func:`process_device` of ``device``) is a
    card, gloo otherwise; ``backend`` overrides that (two ranks on one card
    need gloo: NCCL refuses them). Returns the group."""
    coordinator_address = coordinator_address or os.environ.get(COORD_ENV)
    if num_processes is None and os.environ.get(NPROC_ENV):
        num_processes = int(os.environ[NPROC_ENV])
    if process_id is None and os.environ.get(PID_ENV):
        process_id = int(os.environ[PID_ENV])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(f"a process group needs the coordinator's address, the number of "
                         f"processes and this process's id (--coordinator, --num_processes, "
                         f"--process_id or {COORD_ENV}, {NPROC_ENV}, {PID_ENV}); got "
                         f"{coordinator_address!r}, {num_processes!r}, {process_id!r}")
    device = process_device(device, process_id)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kwargs)
    return dist.group.WORLD


def maybe_initialize_from_env(device=None) -> bool:
    """Join the group when ``RTVC_COORDINATOR`` is set and this process is
    in none yet. Returns whether it did."""
    if os.environ.get(COORD_ENV) is None or dist.is_initialized():
        return False
    initialize(device=device)
    return True


def add_launch_args(parser) -> None:
    """The multi-process launch flags of an entry module (the environment
    works too)."""
    g = parser.add_argument_group(
        "distributed", "Multi-process data-parallel launch, one process per device "
        f"(or env: {COORD_ENV}/{NPROC_ENV}/{PID_ENV})")
    g.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="Address of process 0's rendezvous.")
    g.add_argument("--num_processes", type=int, default=None)
    g.add_argument("--process_id", type=int, default=None)


def setup_from_args(args) -> Optional[dist.ProcessGroup]:
    """Join the group when the launch flags or the environment name a
    coordinator, on the device ``args.device`` names (see
    :func:`process_device`). Returns the group, to pass to the trainers as
    ``dp``, or None when neither names one (one process, no group)."""
    if not (getattr(args, "coordinator", None) or os.environ.get(COORD_ENV)):
        return None
    return initialize(getattr(args, "coordinator", None), getattr(args, "num_processes", None),
                      getattr(args, "process_id", None), device=getattr(args, "device", None))


# ---------------------------------------------------------------------------
# Parameters, gradients and rows
# ---------------------------------------------------------------------------
#
# The JAX package's ``global_batch`` has no counterpart: it assembles every
# process's rows into one global array for a jitted step, whereas here each
# rank keeps its own rows and the step's collectives make them one batch.


def replicate_global(module: torch.nn.Module, group) -> None:
    """Make ``module``'s parameters and buffers rank 0's on every rank (in
    place): equal seeds and one shared checkpoint give equal values already,
    and this makes them so whatever each rank read."""
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, dist.get_global_rank(group, 0), group=group)


def average_gradients(params: Iterable[Tensor], group) -> None:
    """Every ``.grad`` of ``params`` replaced by its mean over the ranks, in
    one all-reduce."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _gather(x: Tensor, group) -> Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class _AllGatherRows(torch.autograd.Function):
    """Forward: every rank's rows, in rank order. Backward: the cotangents
    summed over the ranks (every rank's loss read every row), then this
    rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        lo = dist.get_rank(ctx.group) * ctx.rows
        return grad[lo:lo + ctx.rows], None


class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum over the ranks. Backward: the cotangents summed over
    the ranks, since every rank's sum reads this rank's term."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_gather_rows(x: Tensor, group) -> Tensor:
    """(rows, ...) on each rank → (ranks · rows, ...), rank 0's rows first;
    differentiable (the rows must have one shape on every rank)."""
    return _AllGatherRows.apply(x, group)


def all_reduce_sum(x: Tensor, group) -> Tensor:
    """The sum of ``x`` over the ranks; differentiable."""
    return _AllReduceSum.apply(x, group)


def fetch(x: Tensor, group) -> Tensor:
    """Every rank's rows of ``x``, in rank order, without a gradient (the
    JAX package's ``fetch`` of a batch-sharded array)."""
    with torch.no_grad():
        return _gather(x.detach(), group)


def mean_over_ranks(values: Tensor, group) -> Tensor:
    """The mean of ``values`` (a detached tensor of statistics) over the
    ranks."""
    out = values.detach().clone()
    dist.all_reduce(out, group=group)
    return out / dist.get_world_size(group)


# ---------------------------------------------------------------------------
# Random masks at the global batch's shape
# ---------------------------------------------------------------------------


class ShardRows(NamedTuple):
    """A step's generator under data parallelism: a draw for ``rows`` of a
    batch is made for ``world`` times as many and this rank (``rank``) keeps
    its own, so the ranks together draw what one process draws for the
    global batch."""
    generator: torch.Generator
    rank: int
    world: int


def shard_rows(generator: Optional[torch.Generator], group) -> Optional[object]:
    """``generator`` as a :class:`ShardRows` of ``group`` (as it is without
    a group or a generator)."""
    if group is None or generator is None:
        return generator
    return ShardRows(generator, dist.get_rank(group), dist.get_world_size(group))


def uniform(shape: Sequence[int], generator, device, dim: int = 0) -> Tensor:
    """``torch.rand(shape)`` from ``generator`` (a ``torch.Generator``,
    None for the global one, or a :class:`ShardRows`, whose draw spans every
    rank's rows along the batch axis ``dim``)."""
    if not isinstance(generator, ShardRows):
        return torch.rand(tuple(shape), generator=generator, device=device)
    full = list(shape)
    full[dim] *= generator.world
    u = torch.rand(full, generator=generator.generator, device=device)
    return u.narrow(dim, generator.rank * shape[dim], shape[dim])
