"""Pipeline parallelism: GPipe-style microbatch streaming over a mesh axis
(port of ``spartan_tpu/parallel/pipeline.py``).

Stages are split over a mesh axis (stage s's parameters at position s);
microbatches enter at stage 0 and move one hop a tick by
``ring_permute``, so at steady state every stage computes at once: the
GPipe schedule of ``n_micro + n_stages - 1`` ticks, run as one
``shard_map`` (``parallel/shard_map.py``) on either runner. The last
stage's outputs are shared with every stage by an ``all_reduce``.
Gradients come from ``torch.autograd`` through the whole schedule: on
the thread runner the positions' tensors form one graph, on the group
runner the collectives carry their transposes.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from ..array import tiling as tiling_mod
from ..array.tiling import Tiling
from . import collectives as coll
from . import mesh as mesh_mod
from .shard_map import shard_map


def _flatten(tree: Any) -> Tuple[List[torch.Tensor], Callable]:
    """The tensors of a tuple/list/dict tree, and the function that
    rebuilds the tree from a list of the same length."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (tuple, list)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        raise TypeError(f"stage_params leaves must be tensors, not "
                        f"{type(tree).__name__}")
    sizes = [len(p[0]) for p in parts]
    leaves = [x for p in parts for x in p[0]]

    def rebuild(new: List[Any]) -> Any:
        out, i = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(new[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, rebuild


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, microbatches: torch.Tensor, *,
                   mesh=None, axis: str = mesh_mod.AXIS_ROW
                   ) -> torch.Tensor:
    """Run ``n_micro`` microbatches through a pipeline of stages.

    ``stage_fn(params_s, act) -> act`` is one stage's computation and
    keeps the activation's shape. ``stage_params`` is a tree (tensor,
    tuple, list or dict) whose leaves have a leading ``n_stages`` axis,
    split over ``axis``; ``microbatches`` is ``(n_micro, mb, ...)``.
    Returns ``(n_micro, mb, ...)``. ``stage_fn`` runs on every stage's
    carry on every tick (bubble values included, seeded from the first
    microbatch), so it should be finite on activation-shaped data."""
    mesh = mesh or mesh_mod.get_mesh()
    n_stages = mesh.shape[axis]
    n_micro = microbatches.shape[0]
    if n_micro < 1:
        raise ValueError("need at least one microbatch")
    ticks = n_micro + n_stages - 1
    leaves, rebuild = _flatten(stage_params)
    for leaf in leaves:
        if leaf.shape[0] != n_stages:
            raise ValueError(f"a stage_params leaf has leading extent "
                             f"{leaf.shape[0]}, the mesh axis {axis!r} "
                             f"{n_stages} stages")
    in_t = [Tiling((axis,) + (None,) * (leaf.ndim - 1)) for leaf in leaves]
    in_t.append(tiling_mod.replicated(microbatches.ndim))

    def body(*args):
        params = rebuild([p[0] for p in args[:-1]])
        x = args[-1]
        stage = coll.axis_index(axis)
        # the stage's role as a selector, not as control flow: every
        # position runs the same graph, so on the group runner every
        # collective's transpose runs on every rank
        first = torch.tensor(stage == 0, device=x.device)
        last = torch.tensor(stage == n_stages - 1, device=x.device)
        act = x[0]
        outs: List[Any] = [torch.zeros_like(x[0])] * n_micro
        for t in range(ticks):
            if t < n_micro:
                # stage 0 takes microbatch t while there is one
                act = torch.where(first, x[t], act)
            act = stage_fn(params, act)
            m = t - (n_stages - 1)
            if m >= 0:
                # the last stage emits the microbatch that entered at m
                outs[m] = torch.where(last, act, outs[m])
            act = coll.ring_permute(act, axis, 1)
        # the outputs live on the last stage; share them with everyone
        return coll.all_reduce(torch.stack(outs) * last.to(x.dtype), axis)

    return shard_map(body, mesh, in_t,
                     tiling_mod.replicated(microbatches.ndim))(
        *leaves, microbatches)


def pipeline_loss(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                  loss_fn: Callable[[torch.Tensor, torch.Tensor],
                                    torch.Tensor],
                  stage_params: Any, microbatches: torch.Tensor,
                  targets: torch.Tensor, *, mesh=None,
                  axis: str = mesh_mod.AXIS_ROW) -> torch.Tensor:
    """Mean of ``loss_fn`` over the microbatches run through the
    pipeline."""
    out = pipeline_apply(stage_fn, stage_params, microbatches, mesh=mesh,
                         axis=axis)
    return torch.stack([loss_fn(out[i], targets[i])
                        for i in range(out.shape[0])]).mean()


def pipeline_grad(stage_fn, loss_fn, stage_params, microbatches, targets,
                  *, mesh=None, axis: str = mesh_mod.AXIS_ROW):
    """(loss, grads) for one pipelined training step: grads have the
    structure of ``stage_params``."""
    leaves, rebuild = _flatten(stage_params)
    with torch.enable_grad():
        live = [leaf.detach().requires_grad_(True) for leaf in leaves]
        loss = pipeline_loss(stage_fn, loss_fn, rebuild(live), microbatches,
                             targets, mesh=mesh, axis=axis)
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), rebuild(list(grads))
