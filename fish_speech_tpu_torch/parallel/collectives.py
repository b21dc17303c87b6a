"""The collectives that GSPMD inserts implicitly in the JAX package.

Each takes a process group (None: a group of this rank alone, where the
collective is the identity). On "nccl" the all-gather is NCCL's own; on
"gloo" it is an all-reduce: the PyTorch docs list only `broadcast` and
`all_reduce` among gloo's collectives on CUDA tensors, so every rank
fills its own slot of a zeroed byte buffer and the SUM of bytes, each
slot the sum of one value and zeros, is that value exactly.

Exactness, which is what lets TP=2 give TP=1's bits on int8 weights:
- `all_gather` moves bits (on gloo through the byte SUM above): exact;
- `all_reduce_max` is exact in any order;
- `all_reduce_sum` is exact on integer tensors (the W8A8 products' int32
  accumulators) and rounds on floating ones (a plain model's row-parallel
  partial sums), as GSPMD's psum does.
"""

from __future__ import annotations

import torch


def _dist():
    import torch.distributed as dist

    return dist


def group_size(group) -> int:
    return 1 if group is None else _dist().get_world_size(group)


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in group-rank order
    (every rank's `x` has the same shape and type)."""
    n = group_size(group)
    if n == 1:
        return x
    dist = _dist()
    x = x.contiguous()
    if dist.get_backend(group) == "nccl":
        out = x.new_empty((n, *x.shape))
        dist.all_gather_into_tensor(out, x, group=group)
    else:
        raw = x.reshape(-1).view(torch.uint8)
        buf = torch.zeros((n, raw.numel()), dtype=torch.uint8,
                          device=x.device)
        buf[dist.get_rank(group)] = raw
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        out = buf.view(x.dtype).reshape(n, *x.shape)
    return torch.cat(list(out.unbind(0)), dim=dim)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over the group (a new tensor)."""
    if group_size(group) == 1:
        return x
    dist = _dist()
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum over the group (a new tensor); a floating
    tensor is summed in f32 and returned in its own type."""
    if group_size(group) == 1:
        return x
    dist = _dist()
    out = x.to(torch.float32 if x.is_floating_point() else x.dtype,
               memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.dtype)
