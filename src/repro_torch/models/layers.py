"""Shared layers of the model zoo (port of `repro/models/layers.py`).

Each layer has ``<layer>_specs(cfg) -> {name: TensorSpec}`` and a
functional ``<layer>_apply(p, cfg, x, ...)`` over a dict of tensors, in the
reference's layouts: activations (B,T,d), q (B,T,H,hd), k and v
(B,S,KV,hd), ``wq`` (d,H,hd), ``wo`` (H,hd,d), caches (B,max_len,KV,hd),
expert weights (E,d,f).  Every cast to the compute dtype and back to
float32 sits where the reference puts it, so bfloat16 rounds at the same
places.

The flash-attention kernel runs where the reference runs its Pallas
kernel: causal self-attention without a cache (the teacher-forced
forward), when `_use_flash` says so.  Prefill, decode, bidirectional and
cross-attention go through `_sdpa`, or `_chunked_sdpa` under
``attention_impl="chunked"``; the MoE's routing and expert products are
plain torch ops, as the reference computes them outside any kernel.  The
MoE takes the reference's local scatter/gather dispatch, or, inside an
`activation_sharding` context whose mesh has a model axis dividing the
experts, the expert-parallel dispatch of `parallel.expert_parallel`.
`shard_activation` pins activations where the reference does; it is the
identity outside a context and on plain tensors.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.spec import TensorSpec
from repro_torch.parallel import spmd
from repro_torch.parallel.constraints import shard_activation
from repro_torch.spans import ATTENTION_CORE, MLP, span

__all__ = [
    "apply_rope",
    "attn_apply",
    "attn_specs",
    "embed_apply",
    "embedding_specs",
    "init_kv_cache_specs",
    "mlp_apply",
    "mlp_specs",
    "moe_apply",
    "moe_experts",
    "moe_route",
    "moe_specs",
    "norm_apply",
    "norm_specs",
    "rope_tables",
    "unembed_apply",
]

Params = Dict[str, torch.Tensor]
_F32 = torch.float32

# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


def norm_specs(cfg: ModelConfig, d: Optional[int] = None) -> Dict[str, TensorSpec]:
    d = d or cfg.d_model
    specs = {"scale": TensorSpec((d,), cfg.pdtype, ("embed",), init="ones")}
    if cfg.norm == "layernorm":
        specs["bias"] = TensorSpec((d,), cfg.pdtype, ("embed",), init="zeros")
    return specs


def norm_apply(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm or LayerNorm with f32 statistics, output in compute dtype."""
    xf = x.to(_F32)
    if cfg.norm == "layernorm":
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + 1e-5)
        y = y * p["scale"].to(_F32) + p["bias"].to(_F32)
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * p["scale"].to(_F32)
    return y.to(cfg.cdtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer ``positions`` (any shape), f32, of shape
    ``positions.shape + (head_dim // 2,)``."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=_F32, device=positions.device) / half)
    angles = positions.to(_F32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (split-half convention).  x: (..., heads, head_dim);
    cos/sin broadcastable to (..., 1, head_dim//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].to(_F32), x[..., half:].to(_F32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attn_specs(cfg: ModelConfig, *, cross: bool = False) -> Dict[str, TensorSpec]:
    """Projection parameters for one attention block; ``cross=True`` is a
    cross-attention block (whisper's decoder), whose K/V projections read
    the encoder's output, without qk-norm."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pd = cfg.pdtype
    specs = {
        "wq": TensorSpec((d, h, hd), pd, ("embed", "heads", "head_dim"), init="scaled_normal"),
        "wk": TensorSpec((d, kv, hd), pd, ("embed", "kv_heads", "head_dim"),
                         init="scaled_normal"),
        "wv": TensorSpec((d, kv, hd), pd, ("embed", "kv_heads", "head_dim"),
                         init="scaled_normal"),
        "wo": TensorSpec((h, hd, d), pd, ("heads", "head_dim", "embed"), init="scaled_normal"),
    }
    if cfg.qkv_bias or cfg.use_bias:
        specs["bq"] = TensorSpec((h, hd), pd, ("heads", "head_dim"))
        specs["bk"] = TensorSpec((kv, hd), pd, ("kv_heads", "head_dim"))
        specs["bv"] = TensorSpec((kv, hd), pd, ("kv_heads", "head_dim"))
    if cfg.use_bias:
        specs["bo"] = TensorSpec((d,), pd, ("embed",))
    if cfg.qk_norm and not cross:
        specs["q_norm"] = TensorSpec((hd,), pd, ("head_dim",), init="ones")
        specs["k_norm"] = TensorSpec((hd,), pd, ("head_dim",), init="ones")
    return specs


def init_kv_cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                        num_layers: int) -> Dict[str, TensorSpec]:
    """Stacked-over-layers KV cache for decode, in the compute dtype."""
    shape = (num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    axes = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    return {"k": TensorSpec(shape, cfg.cdtype, axes), "v": TensorSpec(shape, cfg.cdtype, axes)}


def _rms_head_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.to(_F32)
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale.to(_F32)).to(x.dtype)


def _project_qkv(p: Params, cfg: ModelConfig, xq: torch.Tensor,
                 xkv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    cd = cfg.cdtype
    q = spmd.project("btd,dhk->bthk", xq, p["wq"].to(cd))
    k = spmd.project("bsd,dhk->bshk", xkv, p["wk"].to(cd))
    v = spmd.project("bsd,dhk->bshk", xkv, p["wv"].to(cd))
    q = shard_activation(q, ("batch", "seq", "heads", "head_dim"))
    k = shard_activation(k, ("batch", "seq", "kv_heads", "head_dim"))
    v = shard_activation(v, ("batch", "seq", "kv_heads", "head_dim"))
    if "bq" in p:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    if "q_norm" in p:
        q = _rms_head_norm(q, p["q_norm"])
        k = _rms_head_norm(k, p["k_norm"])
    return q, k, v


def _sdpa(
    q: torch.Tensor,  # (B, T, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,  # (B, S, KV, hd)
    *,
    causal: bool,
    q_offset: Optional[int] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Grouped-query scaled-dot-product attention, f32 softmax.

    The logits come from a product in the inputs' dtype and the
    probabilities are cast to v's dtype before P.V, as in the reference.
    ``q_offset``: absolute position of query 0 (causal mask compares
    i + q_offset >= j); ``kv_len``: only the first ``kv_len`` slots are valid.
    """
    b, t, h, hd = q.shape
    logits = _masked_logits(q, k, causal=causal, q_offset=q_offset, kv_len=kv_len)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", probs.to(v.dtype), v)
    return out.reshape(b, t, h, hd)


def _masked_logits(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                   q_offset: Optional[int], kv_len: Optional[int],
                   k_offset: int = 0) -> torch.Tensor:
    """`_sdpa`'s f32 (B, KV, G, T, S) logits, masked with -1e30; key j sits
    at position ``k_offset`` + j (a slice of a longer cache)."""
    b, t, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, t, kv, h // kv, hd)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("btkgh,bskh->bkgts", qg, k).to(_F32) * scale

    mask = None
    kpos = torch.arange(s, device=q.device)[None, :] + k_offset
    if causal:
        qpos = torch.arange(t, device=q.device)[:, None] + (q_offset or 0)
        mask = qpos >= kpos  # (t, s)
    if kv_len is not None:
        valid = kpos < kv_len
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    return logits


def _sdpa_parts(
    q: torch.Tensor,  # (B, T, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd): keys k_offset .. k_offset + S of the cache
    v: torch.Tensor,
    *,
    causal: bool,
    q_offset: Optional[int] = None,
    kv_len: Optional[int] = None,
    k_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`_sdpa` over one slice of the keys, its softmax not yet normalised
    (`spmd.cache_shards` combines the slices): the row maximum and sum of
    exponentials (B, T, H) and the unnormalised P·V (B, T, H, hd), float32.
    The logits and masks are `_sdpa`'s at the keys' global positions; P is
    cast to v's dtype before P·V, which is summed in float32."""
    b, t, h, hd = q.shape
    logits = _masked_logits(q, k, causal=causal, q_offset=q_offset, kv_len=kv_len,
                            k_offset=k_offset)
    row_max = logits.amax(-1)
    p = logits.sub_(row_max[..., None]).exp_()  # in place: one (B, KV, G, T, S) block
    row_sum = p.sum(-1)
    pv = torch.einsum("bkgts,bskh->btkgh", p.to(v.dtype), v).to(_F32)
    return (row_max.permute(0, 3, 1, 2).reshape(b, t, h),
            row_sum.permute(0, 3, 1, 2).reshape(b, t, h), pv.reshape(b, t, h, hd))


def _chunked_sdpa(
    q: torch.Tensor,  # (B, T, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,  # (B, S, KV, hd)
    *,
    causal: bool,
    chunk: int,
    q_offset: Optional[int] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Online-softmax attention over key chunks of ``chunk`` keys: only a
    (T, chunk) tile of scores exists at a time, with the running maximum,
    denominator and accumulator in float32 (the reference's `lax.scan`, as
    a loop).  The scores come from a product in the inputs' dtype, the
    probabilities are cast to v's dtype before P.V and each chunk's P.V is
    added in float32, as in the reference."""
    b, t, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    if s % chunk:  # the reference falls back on ragged key lengths
        return _sdpa(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    g = h // kv
    qg = q.reshape(b, t, kv, g, hd)
    scale = 1.0 / math.sqrt(hd)
    qpos = torch.arange(t, device=q.device)[:, None] + (q_offset or 0)
    m = torch.full((b, kv, g, t), -1e30, dtype=_F32, device=q.device)
    l = torch.zeros((b, kv, g, t), dtype=_F32, device=q.device)
    acc = torch.zeros((b, kv, g, t, hd), dtype=_F32, device=q.device)
    for c0 in range(0, s, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        logits = torch.einsum("btkgh,bckh->bkgtc", qg, kb).to(_F32) * scale
        kpos = c0 + torch.arange(chunk, device=q.device)[None, :]
        mask = None
        if causal:
            mask = qpos >= kpos
        if kv_len is not None:
            valid = kpos < kv_len
            mask = valid if mask is None else (mask & valid)
        if mask is not None:
            logits = logits.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        pv = torch.einsum("bkgtc,bckh->bkgth", p.to(vb.dtype), vb)
        acc = acc * alpha[..., None] + pv.to(_F32)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]  # (b, kv, g, t, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd).to(q.dtype)


def _use_chunked(cfg: ModelConfig, t: int, s: int) -> bool:
    if cfg.attention_impl != "chunked":
        return False
    return t > 1 and s >= 2 * cfg.attention_chunk and s % cfg.attention_chunk == 0


def _use_flash(cfg: ModelConfig, seq_len: int, device: torch.device) -> bool:
    """Where the flash kernel runs: always for "pallas"; for "auto" on the
    card when the sequence is a multiple of 128 (the reference's rule, with
    the card in the TPU's place)."""
    if cfg.attention_impl == "pallas":
        return True
    if cfg.attention_impl == "auto":
        return device.type == "cuda" and seq_len % 128 == 0
    return False


def attn_apply(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, T, d) queries
    *,
    positions: torch.Tensor,  # (B, T) absolute positions (ints)
    causal: bool = True,
    kv_source: Optional[torch.Tensor] = None,  # cross-attention source (B, S, d)
    cache: Optional[Dict[str, torch.Tensor]] = None,  # {"k","v"} (B, S, KV, hd)
    cache_index: Optional[int] = None,
    use_rope: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One attention block.  Returns (output, cache or None).

    Modes:
      * train / teacher-forced / encoder: cache=None, kv_source=None (self)
        or the encoder's output (cross, bidirectional, no RoPE);
      * prefill: cache=zeroed buffers, cache_index=0, fills [0, T);
      * decode: cache=filled buffers, cache_index=current length.
    The cache is written in place at [cache_index, cache_index + T) and
    returned; the reference returns an updated copy.
    """
    xkv = kv_source if kv_source is not None else x
    q, k, v = _project_qkv(p, cfg, x, xkv)
    t = x.shape[1]

    if use_rope and kv_source is None:
        cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos[:, :, None, :], sin[:, :, None, :])
        k = apply_rope(k, cos[:, :, None, :], sin[:, :, None, :])

    q_offset = kv_len = None
    if cache is not None:
        idx = int(cache_index or 0)
        if idx < 0 or idx + t > cache["k"].shape[1]:
            raise ValueError(f"cache of length {cache['k'].shape[1]} cannot take "
                             f"positions [{idx}, {idx + t})")
        spmd.cache_write(cache["k"], k, idx)
        spmd.cache_write(cache["v"], v, idx)
        cache_axes = ("batch", "cache_seq", "kv_heads", "head_dim")
        k = shard_activation(cache["k"], cache_axes)
        v = shard_activation(cache["v"], cache_axes)
        kv_len = idx + t
        q_offset = idx

    self_attn = kv_source is None
    with span(ATTENTION_CORE):  # attention from q, k, v, whatever route computes it
        if cache is None and self_attn and causal and _use_flash(cfg, t, x.device):
            out = flash_attention(q, k, v, True)
        else:
            chunked = self_attn and _use_chunked(cfg, t, k.shape[1])
            if chunked:
                attend = functools.partial(_chunked_sdpa, causal=causal, chunk=cfg.attention_chunk,
                                           kv_len=kv_len)
            else:
                attend = functools.partial(_sdpa, causal=causal and self_attn, kv_len=kv_len)
            if cache is None or chunked:
                # over DTensors, on this rank's query block (`spmd.query_blocks`);
                # the chunked attention's logits are never whole along the keys
                out = spmd.query_blocks(attend, q, k, v, q_offset)
            else:  # over DTensors, on this rank's slice of the cache (`spmd.cache_shards`)
                parts = functools.partial(_sdpa_parts, causal=causal and self_attn, kv_len=kv_len)
                out = spmd.cache_shards(attend, parts, q, k, v, q_offset)

    out = shard_activation(out, ("batch", "seq", "heads", "head_dim"))
    y = spmd.project("bthk,hkd->btd", out, p["wo"].to(cfg.cdtype))
    if "bo" in p:
        y = y + p["bo"].to(cfg.cdtype)
    return y, cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, TensorSpec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    pd = cfg.pdtype
    if cfg.mlp_act == "swiglu":
        return {
            "wi_gate": TensorSpec((d, f), pd, ("embed", "ffn"), init="scaled_normal"),
            "wi_up": TensorSpec((d, f), pd, ("embed", "ffn"), init="scaled_normal"),
            "wo": TensorSpec((f, d), pd, ("ffn", "embed"), init="scaled_normal"),
        }
    specs = {
        "wi": TensorSpec((d, f), pd, ("embed", "ffn"), init="scaled_normal"),
        "wo": TensorSpec((f, d), pd, ("ffn", "embed"), init="scaled_normal"),
    }
    if cfg.use_bias:
        specs["bi"] = TensorSpec((f,), pd, ("ffn",))
        specs["bo"] = TensorSpec((d,), pd, ("embed",))
    return specs


def mlp_apply(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    with span(MLP):
        cd = cfg.cdtype
        ffn_axes = ("batch", "seq", "ffn")
        if cfg.mlp_act == "swiglu":
            gate = spmd.project("btd,df->btf", x, p["wi_gate"].to(cd))
            up = spmd.project("btd,df->btf", x, p["wi_up"].to(cd))
            h = F.silu(gate.to(_F32)).to(cd) * up
            h = shard_activation(h, ffn_axes)
            return spmd.project("btf,fd->btd", h, p["wo"].to(cd))
        h = spmd.project("btd,df->btf", x, p["wi"].to(cd))
        if "bi" in p:
            h = h + p["bi"].to(cd)
        h = F.gelu(h.to(_F32), approximate="tanh").to(cd)  # jax.nn.gelu's default
        h = shard_activation(h, ffn_axes)
        y = spmd.project("btf,fd->btd", h, p["wo"].to(cd))
        if "bo" in p:
            y = y + p["bo"].to(cd)
        return y


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------


def moe_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The router (float32, as the reference keeps it), the stacked SwiGLU
    experts, and the always-on shared expert or dense residual MLP."""
    if cfg.moe is None:
        raise ValueError("moe_specs needs a MoEConfig")
    moe, d, pd = cfg.moe, cfg.d_model, cfg.pdtype
    e, f = moe.num_experts, moe.d_ff_expert
    specs: Dict[str, Any] = {
        "router": TensorSpec((d, e), _F32, ("embed", "experts"), init="scaled_normal"),
        "wi_gate": TensorSpec((e, d, f), pd, ("experts", "embed", "expert_ffn"),
                              init="scaled_normal"),
        "wi_up": TensorSpec((e, d, f), pd, ("experts", "embed", "expert_ffn"),
                            init="scaled_normal"),
        "wo": TensorSpec((e, f, d), pd, ("experts", "expert_ffn", "embed"),
                         init="scaled_normal"),
    }
    if moe.shared_experts:
        sf = f * moe.shared_experts
        specs["shared"] = {
            "wi_gate": TensorSpec((d, sf), pd, ("embed", "ffn"), init="scaled_normal"),
            "wi_up": TensorSpec((d, sf), pd, ("embed", "ffn"), init="scaled_normal"),
            "wo": TensorSpec((sf, d), pd, ("ffn", "embed"), init="scaled_normal"),
        }
    if moe.dense_residual:
        specs["dense"] = mlp_specs(cfg, d_ff=cfg.d_ff)
    return specs


def _expert_capacity(tokens: int, moe: MoEConfig) -> int:
    cap = int(math.ceil(tokens * moe.top_k * moe.capacity_factor / moe.num_experts))
    return max(cap, moe.top_k)


def moe_route(router: torch.Tensor, moe: MoEConfig,
              xf: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The reference's routing of ``xf`` (N, d) tokens, as tensors:

      * ``probs`` (N, E) float32: softmax of the float32 router logits;
      * ``expert_ids`` / ``gates`` (N, k): the top k, ties to the lower
        expert as `lax.top_k` breaks them (a stable descending sort), the
        gates renormalized over the k;
      * ``keep`` / ``slot`` (k·N,), k-major (slot j of every token, then
        slot j + 1): a pair is kept when fewer than ``capacity`` earlier
        pairs in that order went to its expert, and its slot is
        expert·capacity + its rank there (E·capacity for a dropped pair);
      * ``aux``: the Switch load-balancing loss, E · Σ_e f_e · p_e with f
        the top-1 share, times ``router_aux_weight``.
    """
    n = xf.shape[0]
    e, k = moe.num_experts, moe.top_k
    cap = _expert_capacity(n, moe)
    probs = torch.softmax(xf.to(_F32) @ router.to(_F32), dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert_ids = order.values[:, :k], order.indices[:, :k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    top1 = torch.zeros((e,), dtype=_F32, device=xf.device).index_add_(
        0, expert_ids[:, 0], torch.ones((n,), dtype=_F32, device=xf.device)) / n
    aux = moe.router_aux_weight * e * (probs.mean(0) * top1).sum()
    flat_ids = expert_ids.T.reshape(-1)  # (k*n,) k-major
    onehot = F.one_hot(flat_ids, e)
    rank = (onehot.cumsum(0) - onehot).gather(1, flat_ids[:, None])[:, 0]
    keep = rank < cap
    slot = torch.where(keep, flat_ids * cap + rank, torch.full_like(rank, e * cap))
    return {"probs": probs, "expert_ids": expert_ids, "gates": gates, "keep": keep,
            "slot": slot, "capacity": cap, "aux": aux}


def moe_experts(wi_gate: torch.Tensor, wi_up: torch.Tensor, wo: torch.Tensor,
                cfg: ModelConfig, xf: torch.Tensor, r: Dict[str, torch.Tensor],
                keep: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """The stacked expert SwiGLU over ``xf`` (N, d) tokens routed by ``r``
    (`moe_route`), for the experts ``wi_gate``/``wi_up``/``wo`` hold: E' of
    them, pairs ``keep``-ed into ``slot`` < E'·capacity.  Returns the k
    gated outputs of each token summed in float32, (N, d), unrounded.

    Tokens go into an (E'·C, d) slot buffer, through the experts as batched
    products, and back.  A dropped pair adds nothing: its token's residual
    passes through.
    """
    cd = cfg.cdtype
    n, d = xf.shape
    k, cap, e = cfg.moe.top_k, r["capacity"], wi_gate.shape[0]
    # Scatter (k copies of the tokens, k-major) into the slot buffer; the
    # slots are distinct but for the overflow row, which is dropped.
    buf = torch.zeros((e * cap + 1, d), dtype=cd, device=xf.device)
    buf.index_add_(0, slot, xf.to(cd).repeat(k, 1))
    buf = shard_activation(buf[:e * cap].reshape(e, cap, d), ("experts", "capacity", "act_embed"))
    gate = torch.bmm(buf, wi_gate.to(cd))
    up = torch.bmm(buf, wi_up.to(cd))
    h = F.silu(gate.to(_F32)).to(cd) * up
    h = shard_activation(h, ("experts", "capacity", "expert_ffn"))
    out_buf = torch.bmm(h, wo.to(cd))
    out_flat = shard_activation(out_buf, ("experts", "capacity", "act_embed")).reshape(e * cap, d)
    gathered = out_flat[torch.clamp_max(slot, e * cap - 1)]
    gathered = gathered.masked_fill(~keep[:, None], 0.0)
    flat_gates = r["gates"].T.reshape(-1)
    weighted = gathered * flat_gates[:, None].to(cd)
    return weighted.to(_F32).reshape(k, n, d).sum(0)


def moe_apply(p: Dict[str, Any], cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k capacity-limited MoE.  Returns (output, aux loss).

    Two dispatch paths share the routing math (`moe_route`) and the expert
    products (`moe_experts`):

      * **expert-parallel** (inside an `activation_sharding` context whose
        mesh has a model axis dividing the experts): tokens split over the
        data axes, experts over the model axis, one all-reduce combine —
        `parallel.expert_parallel`;
      * **local scatter/gather** (the reference's local dispatch).

    The k gated outputs (each a compute-dtype product of output and gate)
    are summed in float32 and rounded once to the compute dtype, which is
    how the reference's `jnp.sum` over them accumulates.
    """
    if cfg.moe is None:
        raise ValueError("moe_apply needs a MoEConfig")
    from repro_torch.parallel.expert_parallel import (  # local: it imports this module
        moe_apply_shard_map,
        moe_shard_map_available,
    )

    if moe_shard_map_available(cfg, x.shape):
        y, aux = moe_apply_shard_map(p, cfg, x)
    else:
        b, t, d = x.shape
        xf = x.reshape(b * t, d)
        r = moe_route(p["router"], cfg.moe, xf)
        y = moe_experts(p["wi_gate"], p["wi_up"], p["wo"], cfg, xf, r, r["keep"], r["slot"])
        y = shard_activation(y.to(cfg.cdtype).reshape(b, t, d), ("batch", "seq", "act_embed"))
        aux = r["aux"]
    if "shared" in p:
        y = y + mlp_apply(p["shared"], cfg.replace(mlp_act="swiglu"), x)
    if "dense" in p:
        y = y + mlp_apply(p["dense"], cfg, x)
    return y, aux


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embedding_specs(cfg: ModelConfig) -> Dict[str, TensorSpec]:
    specs = {
        "embedding": TensorSpec((cfg.vocab_size, cfg.d_model), cfg.pdtype, ("vocab", "embed"),
                                init="normal", init_scale=0.02)
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = TensorSpec((cfg.d_model, cfg.vocab_size), cfg.pdtype,
                                      ("embed", "vocab"), init="scaled_normal")
    return specs


class _CastGather(torch.autograd.Function):
    """``table.to(dtype)[index]`` (the reference's cast-then-gather) without
    a ``dtype`` copy of the whole table: the rows are gathered, then cast.
    The gradient is the reference's too: the rows' cotangents summed into
    the table in ``dtype``, then cast to the table's dtype once (summing
    after a cast to a bfloat16 table would round each row's share)."""

    @staticmethod
    def forward(ctx, table, index, dtype):
        ctx.save_for_backward(index)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        return _rows(table, index).to(dtype)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        if isinstance(grad, DTensor):  # the sum DTensor shards (vocab-sharded tables)
            out = torch.ops.aten.embedding_dense_backward(grad, index, ctx.shape[0], -1, False)
        else:
            out = torch.zeros(ctx.shape, dtype=grad.dtype, device=grad.device)
            out.index_put_((index,), grad, accumulate=True)
        return out.to(ctx.dtype), None, None


def _rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[index]``; over a DTensor the embedding lookup, which DTensor
    runs on a vocab-sharded table without gathering it."""
    if isinstance(table, DTensor):
        return F.embedding(index, table)
    return table[index]


def cast_gather(table: torch.Tensor, index: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows ``index`` of ``table`` in ``dtype``, as ``table.to(dtype)[index]``."""
    if table.requires_grad and torch.is_grad_enabled():
        return _CastGather.apply(table, index, dtype)
    return _rows(table, index).to(dtype)


def embed_apply(p: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    emb = cast_gather(p["embedding"], tokens, cfg.cdtype)
    return shard_activation(emb, ("batch", "seq", "act_embed"))


def unembed_apply(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final logits in f32."""
    if cfg.tie_embeddings:
        w = p["embedding"].to(cfg.cdtype).T
    else:
        w = p["unembed"].to(cfg.cdtype)
    logits = spmd.project("btd,dv->btv", x, w).to(_F32)
    return shard_activation(logits, ("batch", "seq", "vocab"))
