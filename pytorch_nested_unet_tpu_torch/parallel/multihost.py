"""Multi-process runs (counterpart of parallel/multihost.py).

Each process runs this same program over one device. `initialize_distributed`
joins the processes into one `torch.distributed` world from the variables
`torchrun` sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); in
one process it does nothing. The backend is NCCL for CUDA devices and Gloo
for the CPU unless the caller names one (Gloo also takes CUDA tensors in
`all_reduce` and `broadcast`, staging them through host memory, which lets
two ranks share one card). A failed `init_process_group` raises: a run never
falls back to one process.

Two ranks on the CPU:

    torchrun --nproc_per_node 2 -m pytorch_nested_unet_tpu_torch.train \
        --device cpu --mesh data=2 ...
"""

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def initialize_distributed(backend: Optional[str] = None, device=None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> bool:
    """Join the processes' world (a no-op returning False in one process).

    Arguments default from torchrun's environment: WORLD_SIZE, RANK and
    tcp://MASTER_ADDR:MASTER_PORT. `backend` defaults to "nccl" when `device`
    is a CUDA device and to "gloo" otherwise. Returns True once this process
    is in a world of more than one process (also when it already was).
    """
    world = int(world_size if world_size is not None else os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and init_method is None:
        return False
    if dist.is_initialized():
        return True
    if rank is None:
        rank = int(os.environ["RANK"])
    if init_method is None:
        init_method = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if backend is None:
        backend = "nccl" if device is not None and torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return True


def initialize_single_process(backend: str = "gloo"):
    """A world of this one process (an in-memory store, no port), so a
    `--mesh data=1` run takes the same collective path as N processes do."""
    dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)


def local_rank() -> int:
    """This process's index among the processes of its machine (LOCAL_RANK)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def spans_machines() -> bool:
    """Whether the processes of this run sit on more than one machine:
    torchrun's LOCAL_WORLD_SIZE (the processes of this machine) below its
    WORLD_SIZE."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    return int(os.environ.get("LOCAL_WORLD_SIZE", world)) != world


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_batch_slice(global_batch: int) -> Tuple[int, int]:
    """(per-process batch, this process's offset) of a global batch that each
    process feeds its own rows of."""
    n_proc = process_count()
    if global_batch % n_proc:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n_proc} processes")
    per = global_batch // n_proc
    return per, per * process_index()


def make_global_array(local_batch: torch.Tensor, group=None) -> torch.Tensor:
    """The global batch from every process's local rows, in rank order (an
    all-gather; every process holds the result). Gloo gathers no CUDA
    tensors, so on a Gloo group they are gathered through host memory."""
    if not dist.is_initialized():
        return local_batch
    world = dist.get_world_size(group)
    staged = dist.get_backend(group) == "gloo" and local_batch.device.type != "cpu"
    src = local_batch.cpu() if staged else local_batch.contiguous()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    return out.to(local_batch.device) if staged else out


def broadcast_object(obj, src: int = 0, group=None):
    """`obj` of process `src` on every process (pickled; small state)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]
