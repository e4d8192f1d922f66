"""Device meshes: a frame's field work spread over several devices (port of
`genefaceplusplus_tpu/parallel/mesh.py`).

JAX shards a frame's rays over a mesh axis `rays` and lets XLA insert the
collectives. The port keeps the axis and its names, and does the split by
hand, on the field's points:

- `make_mesh(n, device)` is a `Mesh`: an ordered list of devices, the first
  the main device. On `cuda` it is the first n cards (and raises where fewer
  exist); on `cpu` it is n shards of the one CPU. `Mesh([...])` takes any
  list, repeats included: `[cuda:0, cuda:0]` runs two shards on two streams
  of one card.
- `shard_rays` splits dim 0 in order into one contiguous block a shard and
  copies each block to its device; `map_blocks` runs a function on each
  shard's block, each shard on its own CUDA stream, and brings the outputs
  back to the main device in order. The shards are launched one after
  another from the caller's thread: CUDA launches return at once, so the
  devices run together. (Launching each from a host thread of its own, as
  `torch.nn.parallel.parallel_apply` does, measured 2-7x slower on four
  H100s with `tools/mesh_launch.py`: the threads take turns on the
  interpreter lock at every op.)
- `replicated(mesh, obj)` makes one replica of a module or of a tuple of
  tensors on each device, once: later calls return the same replicas.
- `init_distributed` joins a job of several processes (hosts) through
  `torch.distributed` and returns the job's device count, as JAX's does.

No collective is hand-written: the blocks and outputs move by PyTorch's
device-to-device copies.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence

import torch

RAY_AXIS = "rays"


def normalized_device(device) -> torch.device:
    """`device` with its index: `cuda` alone is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """An ordered list of devices along one named axis (`RAY_AXIS`); shard i
    runs on `devices[i]` and `main` (the first) holds the frame. A device may
    appear more than once: on a card each shard has a stream of its own.

    The mesh owns its replicas (`replicated`) and its streams."""

    axis_names = (RAY_AXIS,)

    def __init__(self, devices: Sequence):
        self.devices = tuple(normalized_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"a mesh's devices are of one type, got {[str(d) for d in self.devices]}")
        self._replicas = {}  # id(obj) -> (obj, [replica a shard]): obj is held, so its id stays its own
        self._streams: Optional[List[torch.cuda.Stream]] = None

    @property
    def main(self) -> torch.device:
        return self.devices[0]

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis_names={self.axis_names})"

    def streams(self) -> List[torch.cuda.Stream]:
        """One CUDA stream a shard, made at the first call."""
        if self._streams is None:
            self._streams = [torch.cuda.Stream(device=d) for d in self.devices]
        return self._streams


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh of `n_devices` of `device`'s type (the CUDA card unless named,
    as the entry points run): on `cuda`, the first n cards (all where n is
    None), raising where fewer exist than asked; on `cpu`, n shards of the
    one CPU (1 where n is None). JAX's `make_mesh` takes
    `jax.devices()[:n]`, fewer where fewer exist."""
    from genefaceplusplus_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    if device.type == "cpu":
        return Mesh([device] * (1 if n_devices is None else int(n_devices)))
    if device.type != "cuda":
        raise ValueError(f"make_mesh: unsupported device {device}")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"make_mesh: {n} devices asked for")
    if n > count:
        raise RuntimeError(f"make_mesh: {n} CUDA devices asked for, {count} found")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def pad_to_multiple(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def init_distributed(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device=None) -> int:
    """A job of several processes (hosts): `torch.distributed` over
    `coordinator_address` ("host:port" or a URL) with `num_processes` and
    this `process_id`, or from the environment (`env://`: MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK) where no address is given; `nccl` on
    cards, `gloo` on the CPU (`device`, the CUDA card unless named).
    Returns the device count of the whole job: each process's cards (one
    CPU a process on the CPU), summed. Where the rendezvous cannot start
    (no address and no environment) it says so and returns this process's
    count, as JAX's does."""
    import torch.distributed as dist

    from genefaceplusplus_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    local = torch.cuda.device_count() if device.type == "cuda" else 1
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        try:
            if coordinator_address is None:
                dist.init_process_group(backend, init_method="env://")
            else:
                url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
                dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id)
        except ValueError as e:  # env:// without its variables
            print(f"| torch.distributed.init_process_group skipped: {e}")
            return local
    count = torch.tensor([local], dtype=torch.int64,
                         device=torch.device("cuda", torch.cuda.current_device()) if device.type == "cuda" else "cpu")
    dist.all_reduce(count)
    return int(count.item())


def shard_rays(mesh: Mesh, *tensors):
    """Each tensor's dim 0 split in order into `mesh.size` contiguous blocks
    (sizes differ by at most one), block i copied to `mesh.devices[i]` (a
    view where it is there already): a list of blocks a tensor, or the one
    list for one tensor."""
    out = tuple([b.to(d, non_blocking=True) for b, d in zip(torch.tensor_split(t, mesh.size), mesh.devices)]
                for t in tensors)
    return out if len(out) > 1 else out[0]


def _replica(obj, device: torch.device):
    if isinstance(obj, torch.nn.Module):
        current = next(obj.parameters(), None)
        if current is not None and normalized_device(current.device) == device:
            return obj
        return copy.deepcopy(obj).to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # a NamedTuple of tensors (fused_field.FieldWeights)
        return type(obj)(*(t.to(device) for t in obj))
    raise TypeError(f"replicated: cannot replicate a {type(obj).__name__}")


def replicated(mesh: Mesh, obj) -> list:
    """One replica of `obj` (a module, or a NamedTuple of tensors) a
    shard: `obj` itself on its own device, one copy for each other device
    (shards on one device share it). Made at the first call for `obj` and
    kept by the mesh: changes to `obj` after that do not reach the copies."""
    hit = mesh._replicas.get(id(obj))
    if hit is not None and hit[0] is obj:
        return hit[1]
    by_device = {}
    for d in mesh.devices:
        if d not in by_device:
            by_device[d] = _replica(obj, d)
    replicas = [by_device[d] for d in mesh.devices]
    mesh._replicas[id(obj)] = (obj, replicas)
    return replicas


def broadcast(mesh: Mesh, *tensors) -> list:
    """Per-call constants (a frame's condition rows): for each shard, the
    tuple of `tensors` on its device. Not kept."""
    copies = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = tuple(None if t is None else t.to(d, non_blocking=True) for t in tensors)
    return [copies[d] for d in mesh.devices]


def map_blocks(mesh: Mesh, fn: Callable, *tensors):
    """`fn(i, *blocks_i)` on every shard i, where blocks_i are shard i's
    blocks of `tensors` (`shard_rays`), and its outputs (a tensor or a tuple
    of tensors, dim 0 the block's) concatenated in shard order on the main
    device. The shards are launched in turn from the caller's thread; on a
    card each runs on its own stream, ordered after the work that made
    `tensors` and before the main device's next work. A mesh of one device
    that holds the tensors already calls `fn(0, *tensors)` as it is."""
    if mesh.size == 1 and all(normalized_device(t.device) == mesh.main for t in tensors):
        return fn(0, *tensors)
    blocks = [shard_rays(mesh, t) for t in tensors]
    if mesh.main.type != "cuda":
        outs = [fn(i, *(b[i] for b in blocks)) for i in range(mesh.size)]
    else:
        streams = mesh.streams()
        # each device's current stream: the shards' inputs were made there,
        # and the copies back to the main device and the concatenation run there
        ready = {d: torch.cuda.current_stream(d) for d in set(mesh.devices)}
        outs = []
        for i, (d, s) in enumerate(zip(mesh.devices, streams)):
            shard = [b[i] for b in blocks]
            with torch.cuda.device(d), torch.cuda.stream(s):
                s.wait_stream(ready[d])
                for b in shard:
                    b.record_stream(s)  # the caller may free it while s still reads it
                outs.append(fn(i, *shard))
        for i, out in enumerate(outs):
            d = mesh.devices[i]
            ready[d].wait_stream(streams[i])
            for o in (out,) if isinstance(out, torch.Tensor) else out:
                o.record_stream(ready[d])
    single = isinstance(outs[0], torch.Tensor)
    if single:
        outs = [(o,) for o in outs]
    gathered = tuple(torch.cat([out[j].to(mesh.main, non_blocking=True) for out in outs])
                     for j in range(len(outs[0])))
    return gathered[0] if single else gathered
