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

Training differentiates through the collectives, which GSPMD does for
the JAX package. The four operators with gradients below (Megatron's
names in brackets) take those calls forward and pick their backward by
what consumes the result; each is the plain forward call itself when
its input needs no gradient, so the serving path, which trains nothing,
runs the same calls as before:

- `copy_to_group` [copy]: the identity forward, a SUM of the gradient
  over the group backward. It stands before a column-parallel product
  (wqkv, w1, w3, the row-sharded heads), whose rank sees only part of
  the input's gradient, and on a replicated weight that a rank applies
  to its own heads only (the q / k norms);
- `reduce_from_group` [reduce]: a SUM forward, the identity backward
  (a row-parallel product's partial sums; the data group's loss sums);
- `gather_for_replicated`: an all-gather whose backward is the rank's
  own slice of the gradient, for a consumer that every rank computes
  whole (the logits, `fast_project_in`'s output);
- `gather_for_partial`: an all-gather whose backward is a reduce-scatter
  (a SUM, then the rank's slice), for a consumer of which each rank
  computes only its part (wqkv's gathered columns, of which a rank keeps
  its heads).

Each rank of a group issues the same collectives in the same order, in
the backward pass too: the ranks run the same graph.
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


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's contiguous 1/n of `x` along `dim`."""
    n = group_size(group)
    step = x.shape[dim] // n
    return x.narrow(dim, _dist().get_rank(group) * step, step).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.dim), None, None


class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        # a reduce-scatter as the whole SUM, then the rank's slice
        return _slice(all_reduce_sum(g, ctx.group), ctx.group, ctx.dim), \
            None, None


def _trains(x: torch.Tensor, group) -> bool:
    return (group_size(group) > 1 and torch.is_grad_enabled()
            and x.requires_grad)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """`x` forward; its gradient SUMmed over the group backward."""
    return _Copy.apply(x, group) if _trains(x, group) else x


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """`all_reduce_sum` forward; the gradient as it is backward."""
    if _trains(x, group):
        return _Reduce.apply(x, group)
    return all_reduce_sum(x, group)


def gather_for_replicated(x: torch.Tensor, group,
                          dim: int = -1) -> torch.Tensor:
    """`all_gather` forward; the rank's slice of the gradient backward."""
    if _trains(x, group):
        return _GatherReplicated.apply(x, group, dim % x.dim())
    return all_gather(x, group, dim)


def gather_for_partial(x: torch.Tensor, group,
                       dim: int = -1) -> torch.Tensor:
    """`all_gather` forward; the gradient reduce-scattered backward."""
    if _trains(x, group):
        return _GatherPartial.apply(x, group, dim % x.dim())
    return all_gather(x, group, dim)
