"""GPipe-style pipeline parallelism over the "pod" axis (port of
`repro/parallel/pipeline.py`).

Layers are split into S contiguous stages (stage s on pod s, holding
layers [s·L/S, (s+1)·L/S)); microbatches stream through with
point-to-point hand-offs.  The schedule is the classic GPipe forward
wavefront — T = M + S − 1 ticks for M microbatches: at tick t stage 0
injects microbatch t while t < M, stage s works on microbatch t − s, and
the last stage emits microbatch t − S + 1.  The reference computes every
stage at every tick on static shapes (bubble ticks process garbage); here
a stage skips its bubble ticks, which changes no output.  At the end a
masked sum over "pod" broadcasts the last stage's outputs to every stage.

Each rank is a process (`torch.distributed`) holding the whole input
block and the whole stacked parameters, as the reference's `shard_map`
sees replicated operands; the other mesh axes replicate the work.  The
hand-offs are point-to-point sends and receives over the pod group
(`batch_isend_irecv`); gloo takes CPU tensors only, so on the card S > 1
needs a backend with point-to-point support for CUDA tensors.  At S = 1
no collective runs: each microbatch goes through ``stage_fn`` in turn.

Gradients: `pipeline_apply` is one autograd Function, so autograd through
it is the reverse wavefront: the outputs' cotangent is the same on every
rank (the loss downstream is computed identically there), the masked
sum's backward is the identity, the last stage runs its microbatches'
backward in reverse order and each stage sends the cotangent of its
input to s − 1, which runs its own (the hand-off's transpose).  A
Function per hand-off would not do: a stage's first receive and last send
lie on no path to its loss, so autograd would skip their backward on one
side of a pair while the other side waited.  Each stage holds the
gradients of its own layers and stage 0 those of the inputs; the backward
sums them over "pod", so every rank ends with the full gradients.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.models.spec import flatten, unflatten
from repro_torch.parallel.sharding import mesh_axis_size, mesh_dims

__all__ = ["pipeline_apply"]


class _Pod:
    """This rank's stage and the global ranks of its neighbours."""

    def __init__(self, mesh, pod_axis: str):
        # the stages' axis on a mesh dimension of its own: `mesh_dims` raises
        # where it shares one (a mesh merging "pod" and "data")
        (dim,) = mesh_dims(mesh, (pod_axis,), "pipeline stages")
        self.stages = mesh.size(dim)
        self.stage = mesh.get_local_rank(dim)
        self.group = mesh.get_group(dim)
        ranks = dist.get_process_group_ranks(self.group)
        self.prev = ranks[self.stage - 1] if self.stage > 0 else None
        self.next = ranks[self.stage + 1] if self.stage < self.stages - 1 else None

    def send(self, t: torch.Tensor, to: int) -> None:
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, t.contiguous(), to,
                                                      self.group)]):
            req.wait()

    def recv(self, like: torch.Tensor, frm: int) -> torch.Tensor:
        out = torch.empty_like(like)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.irecv, out, frm, self.group)]):
            req.wait()
        return out


class _Pipeline(torch.autograd.Function):
    """The schedule of one stage (module docstring); returns the outputs,
    the same on every rank."""

    @staticmethod
    def forward(ctx, pod: _Pod, stage_fn, tree, grad: bool, inputs, *leaves):
        m = inputs.shape[0]
        per = [leaf.shape[0] // pod.stages for leaf in leaves]
        ctx.pod, ctx.shapes, ctx.m = pod, [leaf.shape for leaf in leaves], m
        ctx.layers = [slice(pod.stage * n, (pod.stage + 1) * n) for n in per]
        local = [leaf[sl].detach().requires_grad_(leaf.requires_grad)
                 for leaf, sl in zip(leaves, ctx.layers)]
        params = unflatten(tree, local)
        ctx.local, ctx.saved = local, []
        outputs = torch.zeros_like(inputs)
        with torch.set_grad_enabled(grad):  # each microbatch's graph, for the backward
            for t in range(m + pod.stages - 1):  # the ticks
                mb = t - pod.stage  # the microbatch this stage holds at tick t
                if not 0 <= mb < m:
                    continue  # a bubble
                h_in = inputs[mb] if pod.prev is None else pod.recv(inputs[mb], pod.prev)
                h_in = h_in.detach().requires_grad_(grad)
                h_out = stage_fn(params, h_in)
                ctx.saved.append((h_in, h_out))
                if pod.next is not None:
                    pod.send(h_out.detach(), pod.next)
                else:  # the last stage emits microbatch t - S + 1
                    outputs[mb] = h_out.detach()
        dist.all_reduce(outputs, group=pod.group)  # the masked sum: others hold zeros
        return outputs

    @staticmethod
    def backward(ctx, g):
        pod, need = ctx.pod, ctx.needs_input_grad
        wanted = [p for p in ctx.local if p.requires_grad]
        acc = [torch.zeros_like(p) for p in wanted]
        g_inputs = torch.zeros_like(g)
        for mb in reversed(range(ctx.m)):  # the reverse wavefront
            h_in, h_out = ctx.saved[mb]
            g_out = g[mb] if pod.next is None else pod.recv(h_out, pod.next)
            got = torch.autograd.grad(h_out, [h_in] + wanted, g_out, allow_unused=True)
            for a, gp in zip(acc, got[1:]):
                if gp is not None:
                    a.add_(gp)
            g_in = torch.zeros_like(h_in) if got[0] is None else got[0]
            if pod.prev is not None:
                pod.send(g_in, pod.prev)
            else:
                g_inputs[mb] = g_in
        ctx.saved = None
        grads = [None, None, None, None, None]
        if need[4]:
            dist.all_reduce(g_inputs, group=pod.group)  # stage 0's, to every stage
            grads[4] = g_inputs
        it = iter(acc)
        for i, (shape, sl, p) in enumerate(zip(ctx.shapes, ctx.layers, ctx.local), start=5):
            if not need[i]:
                grads.append(None)
                continue
            full = g.new_zeros(shape, dtype=p.dtype)
            full[sl] = next(it) if p.requires_grad else 0
            dist.all_reduce(full, group=pod.group)  # each stage's layers, to every stage
            grads.append(full)
        return tuple(grads)


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,  # tree; leaves stacked (num_layers, ...)
    micro_inputs: torch.Tensor,  # (M, b, ...) microbatched activations
    *,
    mesh,
    pod_axis: str = "pod",
) -> torch.Tensor:
    """Run ``stage_fn(local_params, h)`` as an S-stage GPipe.

    ``stage_fn`` receives the stage's slice of the parameters (layers/S on
    the leading axis of every leaf) and one microbatch of activations, and
    returns activations of the same shape.  Returns the (M, b, ...)
    outputs, the same on every rank.
    """
    m = micro_inputs.shape[0]
    if mesh_axis_size(mesh, pod_axis) == 1:  # no hand-off, no broadcast
        return torch.stack([stage_fn(stage_params, micro_inputs[i]) for i in range(m)])
    leaves = flatten(stage_params)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in [micro_inputs] + leaves)
    return _Pipeline.apply(_Pod(mesh, pod_axis), stage_fn, stage_params, grad, micro_inputs,
                           *leaves)
