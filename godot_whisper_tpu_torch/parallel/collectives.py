"""The collectives of tensor and data parallelism, as autograd functions.

The JAX package annotates its weights and lets GSPMD insert the reductions
(``parallel/sharding.py``); in PyTorch, one process per device, the model
code calls them itself.  Megatron's three operations cover every place
GSPMD puts one:

- ``reduce_from_tp``: all-reduce forward, identity backward (the partial
  products of a row-parallel weight, the logits);
- ``copy_to_tp``: identity forward, all-reduce backward (a replicated
  tensor entering a rank-local product: its gradient is the sum of the
  ranks' partial gradients);
- ``gather_from_tp``: the slices of a feature axis gathered to full width,
  backward this rank's slice of the gradient.

Every collective is an ``all_reduce``: gloo takes CUDA tensors only for
``all_reduce`` and ``broadcast``, so the gather writes this rank's slice
into a zeroed full-width tensor (f32, or x's dtype where wider) and
all-reduces it.  Adding zeros is
exact, so the result equals an all-gather bit for bit, and one code path
runs on NCCL and on gloo.

With no group (``None``, which is also what a mesh gives at width 1) each
operation returns its input and launches nothing.  ``census`` counts the
collectives by (op, shape): calls, reset by the caller
(``census.clear()``), as the kernels' launch counters are.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

# (op, shape) -> calls; op is "reduce", "gather", "grad_reduce" (the
# backward of copy_to_tp) or "dp_reduce"
census: "collections.Counter[tuple]" = collections.Counter()


@dataclasses.dataclass(frozen=True, eq=False)
class Group:
    """One axis of the mesh as this rank sees it: the process group, its
    size and this rank's index in it."""
    group: Any
    size: int
    rank: int


def tp_size(tp: Optional[Group]) -> int:
    """Width of a group, 1 for None."""
    return 1 if tp is None else tp.size


def census_summary() -> Dict[str, Any]:
    """{"count": calls, "elements": elements moved, "max_elements": the
    largest call, "by_op": {op: calls}} over ``census``."""
    count = sum(census.values())
    elements = sum(math.prod(shape) * n for (_, shape), n in census.items())
    by_op: Dict[str, int] = collections.Counter()
    for (op, _), n in census.items():
        by_op[op] += n
    return {"count": count, "elements": elements,
            "max_elements": max((math.prod(s) for _, s in census),
                                default=0),
            "by_op": dict(by_op)}


def all_reduce(x: torch.Tensor, group: Group, op: str) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place (counted as ``op``); returns x."""
    census[(op, tuple(x.shape))] += 1
    dist.all_reduce(x, group=group.group)
    return x


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        return all_reduce(x.clone(), group, op)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group,
                          "grad_reduce"), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * group.size
        full = torch.zeros(shape, device=x.device,
                           dtype=torch.promote_types(x.dtype, torch.float32))
        full.narrow(dim, group.rank * n, n).copy_(x)
        return all_reduce(full, group, "gather").to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.group.size
        return g.narrow(ctx.dim, ctx.group.rank * n, n), None, None


def reduce_from_tp(x: torch.Tensor, tp: Optional[Group]) -> torch.Tensor:
    """Sum of the ranks' partial values (all-reduce), identity backward."""
    return x if tp is None else _Reduce.apply(x, tp, "reduce")


def copy_to_tp(x: torch.Tensor, tp: Optional[Group]) -> torch.Tensor:
    """A replicated tensor entering rank-local products: identity forward,
    the ranks' gradients summed backward."""
    return x if tp is None else _Copy.apply(x, tp)


def gather_from_tp(x: torch.Tensor, tp: Optional[Group],
                   dim: int = -1) -> torch.Tensor:
    """This rank's slice of axis ``dim`` -> the full axis, in rank order
    (the zero-fill all-reduce, in f32 or wider, then x's dtype); backward,
    this rank's slice of the gradient."""
    return x if tp is None else _Gather.apply(x, tp, dim % x.dim())


def reduce_over(x: torch.Tensor, group: Optional[Group],
                op: str = "dp_reduce") -> torch.Tensor:
    """``reduce_from_tp`` over another axis of the mesh (the data-parallel
    loss sum), counted as ``op``; without a group, x."""
    return x if group is None else _Reduce.apply(x, group, op)
