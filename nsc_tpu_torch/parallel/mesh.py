"""Data parallelism over `torch.distributed` (counterpart of
`nsc_tpu/parallel/mesh.py`).

The JAX package trains data-parallel over a mesh with one 'data' axis:
the batch sharded on it, the state replicated, and the step under
`shard_map`, where `lax.pmean` / `lax.psum` keep every replica's state the
same. Here each rank is a process with one device (NCCL between cards,
gloo on the CPU), and the names map as follows:

  Mesh, 'data' axis       `Mesh`: the default process group's rank and
                          world size, and the rank's device; it is the
                          `axis` the train step and the RVQ forward take
                          where the JAX step takes `axis_name`
  make_mesh(devices)      `make_mesh()`: the default process group,
                          initialised from the `env://` variables that
                          `torchrun` / `python -m torch.distributed.run`
                          set when it is not initialised yet
  shard_batch(mesh, b)    this rank's rows of a global batch (N must divide
                          by the world size), on the rank's device
  replicate(mesh, tree)   rank 0's tensors broadcast in place to every
                          rank, then checked bit for bit across the ranks
                          (`assert_replicated`)
  lax.psum / lax.pmean    `Mesh.psum_` / `Mesh.pmean_` (in place, one
                          all_reduce over a flat buffer), `pmean_metrics`
  make_parallel_infer     each rank runs its rows, the outputs are gathered
                          in rank order (no other collective)
  make_parallel_train_step  the port's step with `axis=mesh` (the gradient,
                          EMA, reseed and metric reductions are inside it:
                          `train/train.py`)

Within a process nothing is sharded: one rank is one device. A global
batch of N rows is N / world rows a rank, in rank order, as the JAX
package's 'data' axis lays it out.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Dict, List

import torch
import torch.distributed as dist

@dataclasses.dataclass(frozen=True)
class Mesh:
    """The default process group as a data-parallel axis: `rank` of `size`
    processes, each on `device`."""

    rank: int
    size: int
    device: torch.device

    def psum_(self, tensors: List[torch.Tensor]) -> None:
        """Sum each tensor over the ranks, in place (one all_reduce of a
        flat float32 buffer; each value is copied out and back unchanged
        with one rank)."""
        if not tensors:
            return
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        off = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n

    def pmean_(self, tensors: List[torch.Tensor]) -> None:
        """`psum_`, then a division by the world size (the JAX step sums
        the replicas' local-mean gradients and divides by the axis size)."""
        self.psum_(tensors)
        for t in tensors:
            t.div_(self.size)

    def pmean_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Every 0-dim metric averaged over the ranks (float32, on the
        rank's device)."""
        names = list(metrics)
        vals = torch.stack([metrics[k].to(self.device, torch.float32).reshape(()) for k in names])
        self.pmean_([vals])
        return {k: vals[i] for i, k in enumerate(names)}

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()

    def all_gather_object(self, obj) -> list:
        """`obj` of every rank, in rank order."""
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out


def local_device(device=None) -> torch.device:
    """The rank's device: `cuda:<LOCAL_RANK>` for CUDA (the default), else
    `device`. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    return dev


def make_mesh(device=None) -> Mesh:
    """The default process group as a `Mesh`. When it is not initialised
    yet, it is, from the `env://` variables (MASTER_ADDR, MASTER_PORT,
    RANK, WORLD_SIZE), with NCCL for a CUDA device and gloo for the CPU."""
    dev = local_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            dist.init_process_group(backend="nccl", init_method="env://", device_id=dev)
        else:
            dist.init_process_group(backend="gloo", init_method="env://")
    return Mesh(rank=dist.get_rank(), size=dist.get_world_size(), device=dev)


def local_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a global batch of `n`."""
    if n % mesh.size:
        raise ValueError(f"batch {n} not divisible by {mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Mesh, batch) -> torch.Tensor:
    """This rank's rows of a global (N, ...) batch (numpy or tensor), on the
    rank's device."""
    t = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(batch)
    return t[local_rows(mesh, t.shape[0])].contiguous().to(mesh.device)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def digest(tree) -> List[int]:
    """CRC-32 of every tensor leaf's bytes (keys sorted), on the host."""
    return [zlib.crc32(x.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
            for x in _leaves(tree)]


def assert_replicated(mesh: Mesh, tree, what: str = "state") -> None:
    """Raise unless every tensor leaf of `tree` is bit-identical on every
    rank."""
    got = mesh.all_gather_object(digest(tree))
    bad = [r for r in range(mesh.size) if got[r] != got[0]]
    if bad:
        raise RuntimeError(f"{what} differs between rank 0 and ranks {bad}")


def replicate(mesh: Mesh, tree):
    """Rank 0's tensor leaves broadcast to every rank, in place (each leaf
    must already be on the rank's device with rank 0's shape), then checked
    with `assert_replicated`. Returns the tree."""
    with torch.no_grad():
        for x in _leaves(tree):
            dist.broadcast(x.data, src=0)
    assert_replicated(mesh, tree)
    return tree


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The ranks' (n, ...) tensors concatenated in rank order."""
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def make_parallel_infer(model, mesh: Mesh, *, kind: str = "reconstruct"):
    """Data-parallel inference: fn(params, rvq, x, n_q=None) takes the global
    batch (N rows, N divisible by the world size), runs this rank's rows
    through the model's `kind` ('reconstruct' (N, T) -> (N, T), 'encode'
    (N, T) -> (N, F, n_q), 'decode' (N, F, n_q) -> (N, T)) and returns the
    global output on every rank, gathered in rank order. Inference has no
    state across ranks, so the gather is the only collective."""
    method = {"reconstruct": model.reconstruct, "encode": model.encode,
              "decode": model.decode}[kind]

    def run(params, rvq, x, n_q=None):
        with torch.inference_mode():
            out = method(params, rvq, shard_batch(mesh, x), n_q=n_q)
        return all_gather_rows(mesh, out)

    return run


def make_parallel_train_step(model, tcfg, mesh: Mesh):
    """The port's train step over the mesh: (state, this rank's rows of the
    global batch) -> (state, metrics averaged over the ranks). The state
    must start replicated (`replicate`); the step's reductions keep it
    bit-identical across ranks."""
    from nsc_tpu_torch.train.train import make_train_step

    return make_train_step(model, tcfg, axis=mesh)
