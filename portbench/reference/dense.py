"""Plain reference of a dense decoder (Llama-style, as Granite Code is):
pre-norm blocks of grouped-query attention with rotary positions and a
SwiGLU MLP, a final RMSNorm and an untied output head.  Float32 throughout;
weights by the names of `portbench/weights.py`.

`microbatch_loss` is one microbatch's mean shifted cross-entropy plus
z-loss (`common.train_steps` runs the training step around it); each layer
is recomputed in the backward (`torch.utils.checkpoint`) so that a
4096-token row fits beside the state.  `prefill` gives the last position's
logits and each layer's keys (after rotation) and values, the cache a
server keeps.  `layout` names the parameters as the program's tree does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference.common import F32, Precision, attention, loss, mlp, rms_norm, rope

__all__ = ["CACHE_KEYS", "SERVED_IN_COMPUTE", "STATE_NUMBERS", "block", "layout", "logits",
           "microbatch_loss", "prefill"]

# The weights the program reads only in the compute dtype (its
# ``models/model.py::_COMPUTE_DTYPE_WEIGHTS``, for this family).
SERVED_IN_COMPUTE = frozenset({"embedding", "unembed", "wq", "wk", "wv", "wo", "wi_gate",
                               "wi_up"})
CACHE_KEYS = {"k": "k", "v": "v"}  # the program's cache: (layers, B, T, KV, D) keys and values
STATE_NUMBERS = {"kv_err": ("k", "v")}


def _attn_leaves(prefix: str, c: dict, out_std: float) -> list:
    d, h, kv, hd = c["d_model"], c["num_heads"], c["num_kv_heads"], c["head_dim"]
    return [(f"{prefix}.wq", (d, h, hd), "normal", d ** -0.5),
            (f"{prefix}.wk", (d, kv, hd), "normal", d ** -0.5),
            (f"{prefix}.wv", (d, kv, hd), "normal", d ** -0.5),
            (f"{prefix}.wo", (h, hd, d), "normal", out_std / math.sqrt(h * hd))]


def _mlp_leaves(prefix: str, c: dict, out_std: float) -> list:
    d, f = c["d_model"], c["d_ff"]
    return [(f"{prefix}.wi_gate", (d, f), "normal", d ** -0.5),
            (f"{prefix}.wi_up", (d, f), "normal", d ** -0.5),
            (f"{prefix}.wo", (f, d), "normal", out_std / math.sqrt(f))]


def layout(c: dict) -> list:
    """Every parameter: [(name, shape, init, std)] (`portbench/weights.py`
    draws them), the projections that write into the residual stream scaled
    by 1/sqrt(2 * layers)."""
    d, v, n = c["d_model"], c["vocab_size"], c["num_layers"]
    out_std = 1.0 / math.sqrt(2 * n)
    leaves = [("embed.embedding", (v, d), "normal", 0.02)]
    if not c["tie_embeddings"]:
        leaves.append(("embed.unembed", (d, v), "normal", d ** -0.5))
    for i in range(n):
        p = f"layers.{i}"
        leaves += ([(f"{p}.attn_norm.scale", (d,), "ones", 0.0)] + _attn_leaves(f"{p}.attn", c, out_std)
                   + [(f"{p}.mlp_norm.scale", (d,), "ones", 0.0)] + _mlp_leaves(f"{p}.mlp", c, out_std))
    leaves.append(("final_norm.scale", (d,), "ones", 0.0))
    return leaves


def attn(p: Dict[str, torch.Tensor], prefix: str, c: dict, x: torch.Tensor,
         positions: torch.Tensor, prec: Precision, keep: Optional[list] = None) -> torch.Tensor:
    """Causal self-attention of (B, T, d) ``x``; appends (k, v) to ``keep``."""
    q = rope(prec.project("btd,dhk->bthk", x, p[f"{prefix}.wq"]), positions, c["rope_theta"])
    k = rope(prec.project("btd,dhk->bthk", x, p[f"{prefix}.wk"]), positions, c["rope_theta"])
    v = prec.project("btd,dhk->bthk", x, p[f"{prefix}.wv"])
    if keep is not None:
        keep.append((k.detach(), v.detach()))
    return prec.project("bthk,hkd->btd", attention(q, k, v), p[f"{prefix}.wo"])


def block(p: Dict[str, torch.Tensor], prefix: str, c: dict, x: torch.Tensor,
          positions: torch.Tensor, prec: Precision, keep: Optional[list] = None) -> torch.Tensor:
    eps = c["norm_eps"]
    x = x + attn(p, f"{prefix}.attn", c, rms_norm(x, p[f"{prefix}.attn_norm.scale"], eps),
                 positions, prec, keep)
    return x + mlp(rms_norm(x, p[f"{prefix}.mlp_norm.scale"], eps), p, f"{prefix}.mlp", prec)


def logits(p: Dict[str, torch.Tensor], c: dict, h: torch.Tensor, prec: Precision) -> torch.Tensor:
    h = rms_norm(h, p["final_norm.scale"], c["norm_eps"])
    w = p["embed.embedding"].T if c["tie_embeddings"] else p["embed.unembed"]
    return prec.project("btd,dv->btv", h, w)


def _hidden(p, c, tokens, prec, remat: bool, keep=None) -> torch.Tensor:
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = p["embed.embedding"][tokens.long()].to(F32)
    for i in range(c["num_layers"]):
        if remat:
            x = checkpoint(block, p, f"layers.{i}", c, x, positions, prec, use_reentrant=False)
        else:
            x = block(p, f"layers.{i}", c, x, positions, prec, keep)
    return x


@torch.no_grad()
def prefill(p: Dict[str, torch.Tensor], c: dict, tokens: torch.Tensor,
            prec: Precision = Precision()) -> dict:
    """{"logits": (B, V) at the last position, "k"/"v": (layers, B, T, KV, D)}."""
    keep: List = []
    h = _hidden(p, c, tokens, prec, remat=False, keep=keep)
    return {"logits": logits(p, c, h[:, -1:], prec)[:, 0],
            "k": torch.stack([k for k, _ in keep]), "v": torch.stack([v for _, v in keep])}


def microbatch_loss(p, c, tokens, prec, z_weight) -> torch.Tensor:
    return loss(logits(p, c, _hidden(p, c, tokens, prec, remat=True), prec), tokens, z_weight)
