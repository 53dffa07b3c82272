"""The collectives of the sharded renderers, with the gradients JAX's have.

``torch.distributed``'s collectives carry no gradient. Where a value
crosses ranks on its way to the loss, the port needs the transpose that
``jax.lax.all_gather``, ``psum`` and ``ppermute`` have inside ``shard_map``,
under the convention that the objective is the SUM over ranks of each
rank's share (parallel/render.py::make_sharded_train_step):

  all_gather_grad  every rank gets the (n, ...) stack of the group's x; the
                   cotangent of a rank's x is the sum over the group of
                   each rank's cotangent for its slot (a reduce-scatter,
                   done as an all-to-all of the cotangent stacks and a sum
                   in rank order: gloo has no reduce-scatter). psum is
                   all_gather_grad summed in rank order, so it transposes
                   to psum, as JAX's does.
  shift            x moves ``step`` places along the group (JAX's
                   non-cyclic ``ppermute``); the ends receive zeros; the
                   cotangent moves back the other way.

Sums across ranks are taken in rank order from the stacks that all-gather
and all-to-all deliver, never by the backend's reduction, so the bits do
not depend on the algorithm the backend uses. Where no gradient crosses (occlusion bits, hit
indices, the softmax's stop-gradient max), ``all_gather`` is the plain
collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The (n, ...) stack of the group's x, in group rank order; no
    gradient."""
    x = x.detach().contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return torch.stack(out)


def sum_in_order(stack: torch.Tensor) -> torch.Tensor:
    """stack[0] + stack[1] + ... in that order."""
    total = stack[0]
    for k in range(1, stack.shape[0]):
        total = total + stack[k]
    return total


class _AllGatherGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        # mine[k] = rank k's cotangent for this rank's slot.
        g = g.contiguous()
        mine = torch.empty_like(g)
        dist.all_to_all_single(mine, g, group=ctx.group)
        return sum_in_order(mine), None


def all_gather_grad(x: torch.Tensor, group) -> torch.Tensor:
    """The (n, ...) stack of the group's x, differentiable: x's cotangent
    is the sum over the group of the cotangents of its slot."""
    return _AllGatherGrad.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's x in rank order, differentiable (its
    transpose is psum of the cotangents)."""
    return sum_in_order(all_gather_grad(x, group))


def _shifted(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """What the rank ``step`` places back along the group sends: each rank
    sends x to the rank ``step`` places on; zeros where there is none."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    out = torch.zeros_like(x)
    ops = []
    if 0 <= i + step < n:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, i + step), group))
    if 0 <= i - step < n:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, i - step), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step: int):
        ctx.group, ctx.step = group, step
        return _shifted(x.detach(), group, step)

    @staticmethod
    def backward(ctx, g):
        return _shifted(g.contiguous(), ctx.group, -ctx.step), None, None


def shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """JAX's non-cyclic ``ppermute`` by ``step`` along the group: rank i
    receives rank i - step's x (zeros where that rank does not exist),
    differentiable (the cotangent travels back by -step)."""
    return _Shift.apply(x, group, step)
