"""Device mesh construction (counterpart of orbit2_tpu/parallel/mesh.py).

One torch `DeviceMesh` over the process group, with JAX's six axes in JAX's
order:

  stage    - pipeline parallelism: the trunk's Blocks split over it, the
             microbatches handed from stage to stage (parallel/pipeline.py)
  replica  - "simple_ddp": pure data parallelism, parameters replicated
  fsdp     - parameter-sharded data parallelism (ZeRO-3; HSDP's shard axis
             when replica > 1)
  expert   - MoE expert parallelism: the expert stacks split by expert,
             routing whole on every rank
  seq      - sequence parallelism: the trunk's tokens split over it
  tensor   - Megatron-style tensor parallelism

Tensor varies fastest, then seq, expert, fsdp, replica and stage, so rank r
sits where JAX's device r sits (`rank_grid`). One process drives one device:
the world is the process group's size (`world_size`), which `torchrun` sets
up and `init_distributed` joins. As JAX's make_mesh takes the first devices,
the mesh takes the first ranks; a world larger than the mesh leaves the
ranks past it idle (`in_mesh`).

The data-parallel coordinate of a rank is its (replica, fsdp) pair,
`data_rank` / `data_size`: the ranks of one expert, seq and tensor group
share it, and so read the same samples, and so do the ranks of one stage
group. `seq_split` is the seq axis as the trunk splits tokens over it (its
group, size, this rank's coordinate, the sequence attention), `stage_split`
the stage axis as the trunk is pipelined over it, `mesh.moe_group` the
process group of the expert x tensor ranks an MoE layer sums its experts'
outputs over (None where the expert axis is 1: there the layer sums over
the tensor axis's group).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXIS_STAGE = "stage"
AXIS_REPLICA = "replica"
AXIS_FSDP = "fsdp"
AXIS_EXPERT = "expert"
AXIS_SEQ = "seq"
AXIS_TENSOR = "tensor"
AXES = (AXIS_STAGE, AXIS_REPLICA, AXIS_FSDP, AXIS_EXPERT, AXIS_SEQ, AXIS_TENSOR)
# activations: the batch is split over both data axes
BATCH_AXES = (AXIS_REPLICA, AXIS_FSDP)
# an MoE layer's experts and their hidden columns: split over both axes,
# the layer's output summed over their ranks
MOE_AXES = (AXIS_EXPERT, AXIS_TENSOR)


def world_size() -> int:
    """The number of processes in the process group, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank_grid(replica: int = 1, fsdp: int = 1, tensor: int = 1, seq: int = 1, stage: int = 1,
              expert: int = 1, world: Optional[int] = None) -> np.ndarray:
    """The ranks of the mesh as a (stage, replica, fsdp, expert, seq, tensor)
    array, JAX make_mesh's device layout: the first ranks of `world`
    (default: the process group's). A mesh larger than the world raises
    JAX's ValueError."""
    world = world_size() if world is None else world
    want = replica * fsdp * tensor * seq * stage * expert
    if want > world:
        raise ValueError(f"mesh {stage}x{replica}x{fsdp}x{expert}x{seq}x{tensor}={want} > "
                         f"{world} devices")
    return np.arange(want).reshape(stage, replica, fsdp, expert, seq, tensor)


def make_mesh(replica: int = 1, fsdp: int = 1, tensor: int = 1, seq: int = 1, stage: int = 1,
              expert: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """The DeviceMesh of these axis sizes over the first ranks of the
    process group; `mesh.data_group` is the process group of this rank's
    (replica, fsdp) ranks, and `mesh_group` the process group of all its
    ranks (None: the whole world's). Every rank of the world calls it, those
    past the mesh too: making the mesh's process groups is collective. The
    data groups are made by hand, as the expert x tensor ones are: a
    DeviceMesh slice of the data dims fails on a rank past the mesh where
    both are 1."""
    grid = rank_grid(replica, fsdp, tensor, seq, stage, expert)
    mesh = DeviceMesh(device_type, torch.as_tensor(grid), mesh_dim_names=AXES)
    mesh.data_group = _groups_over(grid, BATCH_AXES)
    mesh.moe_group = _groups_over(grid, MOE_AXES) if expert > 1 else None
    mesh.mesh_group = None if grid.size == world_size() else dist.new_group(range(grid.size))
    return mesh


def _groups_over(grid: np.ndarray, axes) -> Optional[object]:
    """This rank's process group over `axes` of the rank grid (the ranks
    that share every other coordinate), None where this rank is past the
    grid. Every rank makes every such group, in one
    order: making a group is collective."""
    dims = [AXES.index(a) for a in axes]
    size = int(np.prod([grid.shape[d] for d in dims]))
    mine, rank = None, dist.get_rank()
    for ranks in np.moveaxis(grid, dims, range(-len(dims), 0)).reshape(-1, size):
        group = dist.new_group(ranks.tolist())
        if rank in ranks:
            mine = group
    return mine


def in_mesh(mesh: DeviceMesh) -> bool:
    """Whether this rank is one of the mesh's: the ranks past it are idle."""
    return mesh.get_coordinate() is not None


def mesh_from_config(parallelism, device_type: str = "cuda") -> DeviceMesh:
    return make_mesh(replica=parallelism.simple_ddp, fsdp=parallelism.fsdp,
                     tensor=parallelism.tensor_par, seq=parallelism.seq_par,
                     stage=getattr(parallelism, "pipeline", 1),
                     expert=getattr(parallelism, "expert_par", 1), device_type=device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def data_size(mesh: DeviceMesh) -> int:
    return axis_size(mesh, AXIS_REPLICA) * axis_size(mesh, AXIS_FSDP)


def data_rank(mesh: DeviceMesh) -> int:
    """This rank's (replica, fsdp) coordinate as one index: the slice of the
    global batch it takes."""
    return (mesh.get_local_rank(AXIS_REPLICA) * axis_size(mesh, AXIS_FSDP)
            + mesh.get_local_rank(AXIS_FSDP))


def data_group(mesh: DeviceMesh):
    """The process group of this rank's data ranks: the (replica, fsdp)
    ranks of its tensor coordinate."""
    return mesh.data_group


def seq_split(mesh: DeviceMesh, impl: str = "gather"):
    """The seq axis as parallel/tensor.py::SeqSplit (its process group, size
    and this rank's coordinate, with the sequence attention `impl`)."""
    from orbit2_tpu_torch.parallel.tensor import SeqSplit

    return SeqSplit(mesh[AXIS_SEQ].get_group(), axis_size(mesh, AXIS_SEQ),
                    mesh.get_local_rank(AXIS_SEQ), impl)


def stage_split(mesh: DeviceMesh, microbatches: int = 0, interleave: int = 1):
    """The stage axis as parallel/pipeline.py::StageSplit (its process group,
    size and this rank's stage, with the schedule's microbatches, 0 for as
    many as stages, and interleave)."""
    from orbit2_tpu_torch.parallel.pipeline import StageSplit

    size = axis_size(mesh, AXIS_STAGE)
    return StageSplit(mesh[AXIS_STAGE].get_group(), size, mesh.get_local_rank(AXIS_STAGE),
                      microbatches or size, interleave)


def sharded_coords(mesh: DeviceMesh, axes) -> tuple:
    """This rank's coordinates along those of `axes` whose size is above 1:
    what a dropout seed folds in (JAX folds an axis index only where the
    axis is sharded, seq_attention.py:88-93)."""
    return tuple(mesh.get_local_rank(a) for a in axes if axis_size(mesh, a) > 1)


def comm_device(device=None) -> torch.device:
    """Where a collective's host-made tensors go: the host under gloo, else
    `device` (None: this process's card)."""
    if dist.get_backend() == "gloo":
        return torch.device("cpu")
    return torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())


def all_ranks(value: int, op, mesh: DeviceMesh, device) -> int:
    """`value` reduced by `op` (a dist.ReduceOp) over the mesh's ranks."""
    t = torch.tensor([value], dtype=torch.int64, device=comm_device(device))
    dist.all_reduce(t, op=op, group=mesh.mesh_group)
    return int(t.item())


def init_distributed(device: str = "cuda") -> int:
    """Joins the process group that torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT), once, and returns the world size:
    NCCL for "cuda" (this process then drives card LOCAL_RANK), gloo for
    "cpu". Without torchrun's variables it starts no group and returns 1.
    A group already started is kept; its backend must be the device's."""
    backend = {"cuda": "nccl", "cpu": "gloo"}.get(torch.device(device).type)
    if backend is None:
        raise ValueError(f"no process-group backend for device {device!r} (cuda | cpu)")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, device {device!r} "
                             f"needs {backend}")
        return dist.get_world_size()
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return 1
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend)
    return dist.get_world_size()


__all__ = ["AXES", "all_ranks", "comm_device", "AXIS_EXPERT", "AXIS_FSDP", "AXIS_REPLICA",
           "AXIS_SEQ", "AXIS_STAGE", "AXIS_TENSOR", "BATCH_AXES", "MOE_AXES", "axis_size",
           "data_group", "data_rank", "data_size", "in_mesh", "init_distributed", "make_mesh",
           "mesh_from_config", "rank_grid", "seq_split", "sharded_coords",
           "stage_split", "world_size"]
