"""Mamba-2 SSD (state-space duality) layer (port of `repro/models/ssm.py`).

Follows Dao & Gu, "Transformers are SSMs" (arXiv:2405.21060).  The layer:

    u (B,L,d) ──in-projections──► z, x, B, C, dt
    x,B,C    ──causal depthwise conv (width d_conv) + silu
    y  = SSD(x·dt, A·dt, B, C)  + D ⊙ x          (selective state space)
    out = out_proj( RMSNorm(y ⊙ silu(z)) )

SSD semantics per head h with state N and head dim P:

    h_t = exp(dt_t A) h_{t-1} + dt_t · B_t x_tᵀ      h ∈ R^{N×P}
    y_t = C_tᵀ h_t + D x_t

computed in O(L·Q) time by splitting L into chunks of Q (``chunk_size``):
an intra-chunk attention-like term (masked by the decay segment-sum) plus an
inter-chunk recurrence over per-chunk states.  The intra-chunk term is the
compute hot spot: ``use_kernel=True`` sends it to the SSD op
(`repro_torch.kernels.ssd`, the hand-written CUDA kernel on the card),
otherwise it is the einsum oracle below.  The recurrence is a Python loop
over chunks (the reference's ``lax.scan``), latency-bound by nature.

Every cast to the compute dtype and back to float32 sits where the
reference puts it, so bfloat16 rounds at the same places.  Prefix sums of
the log-decays are summed in float64 and rounded once to float32
(`_cumsum`), on the CPU and the card alike, as the SSD kernel sums them.  Heads read their
B/C group (``h // (H // G)``) through broadcast views rather than the
reference's ``jnp.repeat`` copies, and the kernel takes B and C per group
and reads each head's group itself.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels.ssd.ops import ssd_diag_chunk
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import TensorSpec
from repro_torch.parallel import spmd
from repro_torch.parallel.constraints import shard_activation

__all__ = [
    "ssm_specs",
    "ssm_state_specs",
    "ssm_apply",
    "ssd_chunked",
    "ssd_decode_step",
]

_F32 = torch.float32

# ---------------------------------------------------------------------------
# Parameters / state
# ---------------------------------------------------------------------------


def ssm_specs(cfg: ModelConfig) -> Dict[str, Any]:
    assert cfg.ssm is not None
    s, d, pd = cfg.ssm, cfg.d_model, cfg.pdtype
    di = s.d_inner(d)
    h = s.num_heads(d)
    gn = s.n_groups * s.d_state
    return {
        "wz": TensorSpec((d, di), pd, ("embed", "ssm_inner"), init="scaled_normal"),
        "wx": TensorSpec((d, di), pd, ("embed", "ssm_inner"), init="scaled_normal"),
        "wB": TensorSpec((d, gn), pd, ("embed", None), init="scaled_normal"),
        "wC": TensorSpec((d, gn), pd, ("embed", None), init="scaled_normal"),
        "wdt": TensorSpec((d, h), pd, ("embed", "heads"), init="scaled_normal"),
        "conv_x": TensorSpec((s.d_conv, di), pd, (None, "ssm_inner"),
                             init="normal", init_scale=0.1),
        "conv_B": TensorSpec((s.d_conv, gn), pd, (None, None),
                             init="normal", init_scale=0.1),
        "conv_C": TensorSpec((s.d_conv, gn), pd, (None, None),
                             init="normal", init_scale=0.1),
        "conv_bias_x": TensorSpec((di,), pd, ("ssm_inner",)),
        "conv_bias_B": TensorSpec((gn,), pd, (None,)),
        "conv_bias_C": TensorSpec((gn,), pd, (None,)),
        # A_log init ~ log(uniform[1,16]) in real mamba2; a fixed spread here.
        "A_log": TensorSpec((h,), _F32, ("heads",), init="ones"),
        "D": TensorSpec((h,), _F32, ("heads",), init="ones"),
        "dt_bias": TensorSpec((h,), _F32, ("heads",), init="zeros"),
        "norm_scale": TensorSpec((di,), pd, ("ssm_inner",), init="ones"),
        "out_proj": TensorSpec((di, d), pd, ("ssm_inner", "embed"),
                               init="scaled_normal"),
    }


def ssm_state_specs(
    cfg: ModelConfig, batch: int, num_layers: int
) -> Dict[str, TensorSpec]:
    """Decode-time recurrent state, stacked over layers.

    ``ssd``:  (layers, B, H, N, P) recurrent state — O(1) in sequence length.
    ``conv``: (layers, B, d_conv-1, channels) rolling conv inputs.
    """
    s = cfg.ssm
    assert s is not None
    di = s.d_inner(cfg.d_model)
    h = s.num_heads(cfg.d_model)
    gn = s.n_groups * s.d_state
    chans = di + 2 * gn
    return {
        "ssd": TensorSpec((num_layers, batch, h, s.d_state, s.head_dim), _F32,
                          ("layers", "batch", "heads", "ssm_state", None)),
        "conv": TensorSpec((num_layers, batch, s.d_conv - 1, chans), cfg.cdtype,
                           ("layers", "batch", None, "ssm_inner")),
    }


# ---------------------------------------------------------------------------
# SSD core — chunked scan (einsum oracle, or the SSD op for the diagonal)
# ---------------------------------------------------------------------------


def _cumsum(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Prefix sums of float32 ``a``, summed in float64 and rounded once
    (`torch.cumsum` of float32 accumulates in float64 on the CPU and in
    float32 on the card)."""
    return torch.cumsum(a.to(torch.float64), dim=dim).to(_F32)


def _segsum(lA: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: out[..., i, j] = Σ_{l=j+1..i} lA[..., l].

    lA: (..., Q) log-decays.  Returns (..., Q, Q) with -inf above diagonal.
    """
    q = lA.shape[-1]
    cs = _cumsum(lA, -1)
    diff = cs[..., :, None] - cs[..., None, :]  # Σ_{l=j+1..i}
    ii = torch.arange(q, device=lA.device)
    return diff.masked_fill(~(ii[:, None] >= ii[None, :]), -torch.inf)


def _over_heads(a: torch.Tensor, rep: int) -> torch.Tensor:
    """(..., G, N) → (..., G·rep, N), head h reading group h // rep: a
    stride-0 view for one group, else the reference's repeat."""
    if a.shape[-2] == 1:
        return a.expand(*a.shape[:-2], rep, a.shape[-1])
    return a.repeat_interleave(rep, dim=-2)


def ssd_chunked(
    x: torch.Tensor,  # (B, L, H, P) inputs (pre-scaled by nothing; dt applied here)
    dt: torch.Tensor,  # (B, L, H) positive step sizes
    A: torch.Tensor,  # (H,) negative decay rates
    B_: torch.Tensor,  # (B, L, G, N)
    C_: torch.Tensor,  # (B, L, G, N)
    *,
    chunk_size: int,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, N, P)
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  Returns (y (B,L,H,P) f32, final_state (B,H,N,P) f32).

    Heads are grouped: head h uses B/C group ``h // (H // G)``.
    """
    b, l, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    q = min(chunk_size, l)
    if l % q:
        # Pad to a chunk multiple with dt=0 steps: decay exp(0·A)=1 and the
        # input contribution dt·Bx = 0, so padding is exactly inert.
        pad = q - l % q
        y, st = ssd_chunked(
            F.pad(x, (0, 0, 0, 0, 0, pad)),
            F.pad(dt, (0, 0, 0, pad)),
            A,
            F.pad(B_, (0, 0, 0, 0, 0, pad)),
            F.pad(C_, (0, 0, 0, 0, 0, pad)),
            chunk_size=chunk_size,
            initial_state=initial_state,
            use_kernel=use_kernel,
        )
        return y[:, :l], st
    nc = l // q
    rep = h // g

    # Chunked views: (B, nc, Q, ...); B and C stay per group.
    xc = x.to(_F32).reshape(b, nc, q, h, p)
    dtc = dt.to(_F32).reshape(b, nc, q, h)
    Bc = B_.to(_F32).reshape(b, nc, q, g, n)
    Cc = C_.to(_F32).reshape(b, nc, q, g, n)
    lA = dtc * A  # (B, nc, Q, H) log decay per step

    # ----- intra-chunk (diagonal) term -------------------------------------
    if use_kernel:
        y_diag = ssd_diag_chunk(xc, dtc, lA, Bc, Cc)  # per group: never copied per head
    else:
        seg = _segsum(lA.movedim(-1, -2))  # (B, nc, H, Q, Q)
        decay = torch.exp(seg)
        scores = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)  # per group
        w = (scores[:, :, :, None] * decay.reshape(b, nc, g, rep, q, q)).reshape(
            b, nc, h, q, q)
        y_diag = torch.einsum("bchqk,bckh,bckhp->bcqhp", w, dtc, xc)

    # ----- inter-chunk recurrence ------------------------------------------
    cum_lA = _cumsum(lA, 2)  # (B, nc, Q, H)
    total_lA = cum_lA[:, :, -1, :]  # (B, nc, H)
    # State contributed by each chunk: decay from step j to chunk end.
    decay_to_end = torch.exp(total_lA[:, :, None, :] - cum_lA)  # (B,nc,Q,H)
    wx = ((decay_to_end * dtc)[..., None] * xc).reshape(b, nc, q, g, rep, p)
    chunk_states = torch.einsum("bcqgn,bcqgrp->bcgrnp", Bc, wx).reshape(b, nc, h, n, p)

    state = (
        initial_state.to(_F32)
        if initial_state is not None
        else torch.zeros((b, h, n, p), dtype=_F32, device=x.device)
    )
    chunk_decay = torch.exp(total_lA)  # (B, nc, H)
    prev_states = torch.empty((b, nc, h, n, p), dtype=_F32, device=x.device)
    for c in range(nc):  # the state *entering* each chunk
        prev_states[:, c] = state
        state = chunk_decay[:, c, :, None, None] * state + chunk_states[:, c]

    # Off-diagonal: queries read the state entering their chunk.
    decay_from_start = torch.exp(cum_lA)  # (B,nc,Q,H) — includes own dt·A
    y_off = torch.einsum("bcqgn,bcgrnp->bcqgrp", Cc,
                         prev_states.reshape(b, nc, g, rep, n, p)).reshape(b, nc, q, h, p)
    y_off = y_off * decay_from_start[..., None]

    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, state


def ssd_decode_step(
    state: torch.Tensor,  # (B, H, N, P) f32
    x: torch.Tensor,  # (B, H, P)
    dt: torch.Tensor,  # (B, H)
    A: torch.Tensor,  # (H,)
    B_: torch.Tensor,  # (B, G, N)
    C_: torch.Tensor,  # (B, G, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step.  Returns (y (B,H,P), new_state)."""
    h = state.shape[1]
    rep = h // B_.shape[1]
    Bf = _over_heads(B_.to(_F32), rep)  # (B,H,N)
    Cf = _over_heads(C_.to(_F32), rep)
    dtf = dt.to(_F32)
    xf = x.to(_F32)
    decay = torch.exp(dtf * A)  # (B,H)
    new_state = decay[..., None, None] * state + torch.einsum(
        "bh,bhn,bhp->bhnp", dtf, Bf, xf)
    y = torch.einsum("bhn,bhnp->bhp", Cf, new_state)
    return y, new_state


def _decode_as_scan(x, dt, A, B_, C_, initial_state):
    """`ssd_decode_step` with `ssd_chunked`'s signature, over inputs of
    length 1: (y (B,1,H,P), new_state)."""
    y, new_state = ssd_decode_step(initial_state, x[:, 0], dt[:, 0], A, B_[:, 0], C_[:, 0])
    return y[:, None], new_state


# ---------------------------------------------------------------------------
# Full layer
# ---------------------------------------------------------------------------


def _causal_conv(
    seq: torch.Tensor,  # (B, L, C)
    w: torch.Tensor,  # (K, C) depthwise taps
    bias: torch.Tensor,  # (C,)
    prev: Optional[torch.Tensor] = None,  # (B, K-1, C) rolling inputs
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, tap by tap in float32 in the reference's order
    (no `conv1d`: cuDNN would run it in TF32).  Returns (out (B,L,C),
    new_prev (B,K-1,C))."""
    k, t = w.shape[0], seq.shape[1]
    if prev is None:
        prev = torch.zeros((seq.shape[0], k - 1, seq.shape[2]), dtype=seq.dtype,
                           device=seq.device)
    ext = torch.cat([prev, seq], dim=1)  # (B, K-1+L, C)
    out = ext[:, 0:t].to(_F32) * w[0].to(_F32)  # the reference's 0 + tap 0
    for i in range(1, k):
        out = out + ext[:, i:i + t].to(_F32) * w[i].to(_F32)
    out = out + bias.to(_F32)
    new_prev = ext[:, -(k - 1):] if k > 1 else prev
    return out.to(seq.dtype), new_prev


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMSNorm(y * silu(z)) — mamba2's gated output norm (f32 stats)."""
    yf = y.to(_F32) * F.silu(z.to(_F32))
    ms = yf.square().mean(-1, keepdim=True)
    return (yf * torch.rsqrt(ms + 1e-6) * scale.to(_F32)).to(y.dtype)


def ssm_apply(
    p: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    u: torch.Tensor,  # (B, T, d)
    *,
    state: Optional[Dict[str, torch.Tensor]] = None,  # decode: {"ssd","conv"}
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One Mamba-2 block.  ``state=None`` → train/prefill-from-scratch path
    (returns final state for cache handoff); state given + T==1 → decode.
    The state passed in is read, not written: the new state is returned."""
    s = cfg.ssm
    assert s is not None
    cd = cfg.cdtype
    b, t, d = u.shape
    di = s.d_inner(d)
    h = s.num_heads(d)
    g, n = s.n_groups, s.d_state
    pdim = s.head_dim

    z = spmd.project("btd,de->bte", u, p["wz"].to(cd))
    x = spmd.project("btd,de->bte", u, p["wx"].to(cd))
    z = shard_activation(z, ("batch", "seq", "ssm_inner"))
    x = shard_activation(x, ("batch", "seq", "ssm_inner"))
    Braw = spmd.project("btd,de->bte", u, p["wB"].to(cd))
    Craw = spmd.project("btd,de->bte", u, p["wC"].to(cd))
    dt_raw = spmd.project("btd,dh->bth", u, p["wdt"].to(cd))
    # jax.nn.softplus is logaddexp(x, 0); torch's softplus turns linear above 20.
    dt = torch.logaddexp(dt_raw.to(_F32) + p["dt_bias"], torch.zeros((), device=u.device))
    A = -torch.exp(p["A_log"])  # (H,) strictly negative

    # over DTensors the depthwise conv runs on channel shards, the sequence
    # whole (the shard moved by one all-to-all, as a concatenation along a
    # split sequence would move it inside the op)
    x, Braw, Craw = (spmd.split_moved(a, 1, 2) for a in (x, Braw, Craw))

    decode = state is not None and t == 1
    conv_prev = None
    if state is not None:
        conv_prev = torch.split(state["conv"], [di, g * n, g * n], dim=-1)

    x, cpx = _causal_conv(x, p["conv_x"], p["conv_bias_x"],
                          conv_prev[0] if conv_prev else None)
    Braw, cpb = _causal_conv(Braw, p["conv_B"], p["conv_bias_B"],
                             conv_prev[1] if conv_prev else None)
    Craw, cpc = _causal_conv(Craw, p["conv_C"], p["conv_bias_C"],
                             conv_prev[2] if conv_prev else None)
    x = F.silu(x.to(_F32)).to(cd)
    Braw = F.silu(Braw.to(_F32)).to(cd)
    Craw = F.silu(Craw.to(_F32)).to(cd)

    xh = x.reshape(b, t, h, pdim)
    Bh = Braw.reshape(b, t, g, n)
    Ch = Craw.reshape(b, t, g, n)

    if decode and isinstance(xh, DTensor):
        # over DTensors the step runs on local shards as the scan does (its
        # einsums merge batch and heads, both split)
        y, new_ssd = spmd.sharded_call("ssd_chunked", _decode_as_scan, xh, dt, A, Bh, Ch,
                                       state["ssd"])
    elif decode:
        y1, new_ssd = ssd_decode_step(
            state["ssd"], xh[:, 0], dt[:, 0], A, Bh[:, 0], Ch[:, 0]
        )
        y = y1[:, None]  # (B,1,H,P)
    else:
        init = [state["ssd"]] if state is not None else []
        scan = functools.partial(ssd_chunked, chunk_size=s.chunk_size, use_kernel=use_kernel)
        if isinstance(xh, DTensor):
            # over DTensors the scan runs on local shards, heads split and
            # the sequence whole
            y, new_ssd = spmd.sharded_call("ssd_chunked", scan, xh, dt, A, Bh, Ch, *init)
        else:
            y, new_ssd = scan(xh, dt, A, Bh, Ch, initial_state=init[0] if init else None)

    y = y + p["D"][None, None, :, None] * xh.to(_F32)
    # laid out as z, so the gated norm's product moves no shard inside the op
    y = shard_activation(y.to(cd).reshape(b, t, di), ("batch", "seq", "ssm_inner"))
    y = shard_activation(_gated_norm(y, z, p["norm_scale"]), ("batch", "seq", "ssm_inner"))
    out = spmd.project("bte,ed->btd", y, p["out_proj"].to(cd))
    out = shard_activation(out, ("batch", "seq", "act_embed"))

    new_state = {"ssd": new_ssd, "conv": torch.cat([cpx, cpb, cpc], dim=-1)}
    return out, new_state
