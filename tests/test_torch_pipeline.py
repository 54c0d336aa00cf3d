"""The port's GPipe (`repro_torch.parallel.pipeline.pipeline_apply`)
against the JAX package's sequential math, with the reference test's
``L, M, B, D = 4, 3, 2, 8`` and ``tanh(h @ w)`` stages (the reference's own
two-stage lane fails on JAX 0.9; `jax.grad` of its `lax.scan` reference
runs live).

At S = 2 the stages are processes: four gloo ranks on a (2, 2) ("pod",
"data") mesh, two stages of two layers, each replicated over "data".  The
outputs and the gradients in ``w`` and ``xs`` equal the sequential
stack's within the reference test's limits, 1e-5 and 1e-4, on every rank.
At S = 1 (one process) the pipeline is the stack applied to each
microbatch, bit for bit.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import pipeline_apply
from torch_dist import fake_world, pipeline_worker, spawn

L, M, B, D = 4, 3, 2, 8  # 4 layers → 2 stages of 2


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((M, B, D)).astype(np.float32)
    return w, xs


def reference(w, xs):
    """The reference test's sequential stack: all layers in order, over
    each microbatch; and the gradients of sum(out²) in w and xs."""
    def full(w, xs):
        def one(h):
            def body(h, wi):
                return jnp.tanh(h @ wi), None
            return jax.lax.scan(body, h, w)[0]
        return jax.vmap(one)(xs)

    out = full(jnp.asarray(w), jnp.asarray(xs))
    gw, gx = jax.grad(lambda w, x: jnp.sum(full(w, x) ** 2), argnums=(0, 1))(
        jnp.asarray(w), jnp.asarray(xs))
    return np.asarray(out), np.asarray(gw), np.asarray(gx)


def test_two_stages_match_sequential_math_and_grads(tmp_path):
    w, xs = inputs()
    out, gw, gx = reference(w, xs)
    ranks = spawn(pipeline_worker, 4, tmp_path, w, xs, (2, 2), ("pod", "data"))
    assert sorted(r["stage"] for r in ranks) == [0, 0, 1, 1]
    for rank, r in enumerate(ranks):
        err = float(np.max(np.abs(r["out"] - out)))
        assert err < 1e-5, (rank, err)
        gerr = max(float(np.max(np.abs(r["gw"] - gw))), float(np.max(np.abs(r["gx"] - gx))))
        assert gerr < 1e-4, (rank, gerr)


def test_single_stage_is_the_plain_stack():
    w, xs = inputs(1)
    out, gw, gx = reference(w, xs)

    def stage_fn(wl, h):
        for wi in wl:
            h = torch.tanh(h @ wi)
        return h

    with fake_world(1):
        mesh = make_mesh((1, 1), ("pod", "data"), "cpu")
        wt = torch.from_numpy(w).requires_grad_(True)
        xt = torch.from_numpy(xs).requires_grad_(True)
        got = pipeline_apply(stage_fn, wt, xt, mesh=mesh)
        (got ** 2).sum().backward()
    plain = torch.stack([stage_fn(wt, xt[i]) for i in range(M)])
    assert torch.equal(got, plain)
    assert float(np.max(np.abs(got.detach().numpy() - out))) < 1e-5
    assert float(np.max(np.abs(wt.grad.numpy() - gw))) < 1e-4
    assert float(np.max(np.abs(xt.grad.numpy() - gx))) < 1e-4
