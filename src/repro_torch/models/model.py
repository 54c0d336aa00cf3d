"""The model facade (port of `repro/models/model.py`) for the dense and SSM families.

`Model(cfg)` is an `nn.Module` that owns the parameters.  Their names
mirror the reference's tree, with the stacked "layers" axis held apart:
the reference's ``params["layers"]["attn"]["wq"][i]`` is the port's
``layers.{i}.attn.wq`` (for the SSM family, ``layers.{i}.norm.*`` and
``layers.{i}.ssm.*``).  The entry points are the reference's:

  * ``param_specs()``                the stacked TensorSpec tree, as the reference's
  * ``forward(batch)``               teacher-forced logits (f32) and aux loss
  * ``loss_fn(batch)``               shifted cross-entropy + z-loss + aux
  * ``cache_specs(batch, max_len)``  / ``init_cache(...)``: the stacked KV
                                     cache, or for the SSM family the recurrent
                                     state (O(1) in length: ``max_len`` unused)
  * ``prefill(batch, cache)``        fill the cache from 0, last-position logits
  * ``decode_step(cache, tokens, index)``

Each takes ``params=`` to run on another tree of the same shape (the
reference's functional form); by default the module's own.  The cache is
updated in place and returned.  Batches are ``{"tokens": (B,T) ints}``
(numpy or torch), with an optional ``loss_mask``.

The SSM family's forward and prefill send every chunked SSD call to the
SSD kernel (``use_kernel=True``): the reference's `Model` leaves
`ssm_apply` at its einsum default, and its kernel is reached only by
calling `ssd_chunked(use_kernel=True)` directly; the two routes compute
the same function (ROADMAP Queue 3).  Decode (T = 1) is the recurrent
step, which has no kernel.  With gradients enabled (training) each
layer's call is wrapped by `parallel.remat.remat_wrap` under
``cfg.remat_policy``, as the reference wraps its scan body.  The other
families (moe, hybrid, encdec, vlm) and learned position tables are not
ported yet and raise (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import TensorSpec, count_params, init_tree, leaves, tree_map
from repro_torch.parallel.remat import remat_wrap

__all__ = ["Model", "total_params"]

Tree = Dict[str, Any]


def total_params(cfg: ModelConfig) -> int:
    return count_params(_param_specs(cfg))


# The weights the reference reads only in the compute dtype (``.astype(cd)``
# at every use, or the embedding's gather-then-cast): `Model.cast_weights_`
# casts these and no others.  The SSM's conv taps are read in float32.
_COMPUTE_DTYPE_WEIGHTS = frozenset({
    "embedding", "unembed",
    "wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo",  # attention
    "wi", "wi_gate", "wi_up", "bi",  # MLP ("wo", "bo" as above)
    "wz", "wx", "wB", "wC", "wdt", "out_proj",  # SSM
})


def _check_ported(cfg: ModelConfig) -> None:
    cfg.validate()
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item 11)")
    if cfg.pos_emb == "learned":
        raise NotImplementedError(
            "learned position tables are not ported yet (ROADMAP Queue 1 item 11)")


def _layer_specs(cfg: ModelConfig) -> Tree:
    """One layer's parameter tree."""
    if cfg.family == "ssm":
        return {"norm": L.norm_specs(cfg), "ssm": S.ssm_specs(cfg)}
    return T.block_specs(cfg)


def _param_specs(cfg: ModelConfig) -> Tree:
    _check_ported(cfg)
    if cfg.family == "ssm":
        layers = T.stack_specs(_layer_specs(cfg), cfg.num_layers)
    else:
        layers = T.decoder_stack_specs(cfg)
    return {"embed": L.embedding_specs(cfg), "layers": layers, "final_norm": L.norm_specs(cfg)}


def _unstacked_specs(cfg: ModelConfig) -> Tree:
    """The port's own parameter tree: one layer dict per layer."""
    _check_ported(cfg)
    return {
        "embed": L.embedding_specs(cfg),
        "layers": [_layer_specs(cfg) for _ in range(cfg.num_layers)],
        "final_norm": L.norm_specs(cfg),
    }


def _as_module(tree: Any) -> nn.Module:
    if isinstance(tree, list):
        return nn.ModuleList([_as_module(v) for v in tree])
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _as_module(v) for k, v in tree.items()})


def _as_tree(m: nn.Module) -> Any:
    if isinstance(m, nn.ParameterDict):
        return dict(m.items())
    if isinstance(m, nn.ModuleList):
        return [_as_tree(v) for v in m]
    return {k: _as_tree(v) for k, v in m.items()}


class Model(nn.Module):
    """A dense or SSM decoder-only model with its parameters.

    ``params``: a tree like `params_tree` gives (e.g. from
    `convert.params_from_jax`), moved to ``device``; otherwise the spec's
    initializers draw them on ``device`` from a `torch.Generator` there,
    seeded with ``seed``.  ``device=None`` is the card (`resolve_device`).
    """

    def __init__(self, cfg: ModelConfig, *, params: Optional[Tree] = None,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        specs = _unstacked_specs(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        if params is None:
            params = init_tree(torch.Generator(device=dev).manual_seed(seed), specs, dev)
        else:
            want = {name: s for name, s in leaves(specs)}
            got = dict(leaves(params))
            if set(got) != set(want):
                raise ValueError(f"parameter names differ from the spec: "
                                 f"missing {sorted(set(want) - set(got))[:5]}, "
                                 f"unexpected {sorted(set(got) - set(want))[:5]}")
            for name, s in want.items():
                if tuple(got[name].shape) != s.shape:
                    raise ValueError(f"{name}: shape {tuple(got[name].shape)} != {s.shape}")
            params = tree_map(lambda x: x.to(dev), params)
        self.embed = _as_module(params["embed"])
        self.layers = _as_module(params["layers"])
        self.final_norm = _as_module(params["final_norm"])

    # -- parameters ---------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.final_norm["scale"].device

    def param_specs(self) -> Tree:
        return _param_specs(self.cfg)

    def total_params(self) -> int:
        return total_params(self.cfg)

    def params_tree(self) -> Tree:
        """The module's parameters as a nested dict, layers as a list."""
        return {"embed": _as_tree(self.embed), "layers": _as_tree(self.layers),
                "final_norm": _as_tree(self.final_norm)}

    @torch.no_grad()
    def cast_weights_(self) -> "Model":
        """Cast, in place, every weight the model only ever reads in the
        compute dtype (`_COMPUTE_DTYPE_WEIGHTS`: the projections and the
        embedding) to that dtype.  The outputs stay the same numbers, each
        forward skips its per-use casts, and those weights take half the
        memory of float32.  The rest stay in their dtype: norm scales, the
        SSM's conv taps, decay rates and skip weights are read in float32."""
        for name, p in self.named_parameters():
            if name.rsplit(".", 1)[-1] in _COMPUTE_DTYPE_WEIGHTS:
                p.data = p.data.to(self.cfg.cdtype)
        return self

    # -- helpers ------------------------------------------------------------

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _final_logits(self, params: Tree, h: torch.Tensor) -> torch.Tensor:
        h = L.norm_apply(params["final_norm"], self.cfg, h)
        return L.unembed_apply(params["embed"], self.cfg, h)

    # -- forward (teacher-forced) --------------------------------------------

    def forward(self, batch: Dict[str, Any],
                params: Optional[Tree] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits (B,T,V) f32 aligned with batch["tokens"], aux loss)."""
        params = params or self.params_tree()
        tokens = self._tokens(batch["tokens"])
        b, t = tokens.shape
        x = L.embed_apply(params["embed"], self.cfg, tokens)
        if self.cfg.family == "ssm":
            h = self._ssm_forward(params, x)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            positions = torch.arange(t, device=tokens.device)[None, :].expand(b, t)
            h, aux, _ = T.decoder_stack_apply(params["layers"], self.cfg, x,
                                              positions=positions)
        return self._final_logits(params, h), aux

    def _ssm_forward(self, params: Tree, x: torch.Tensor) -> torch.Tensor:
        def body(p, h):
            hn = L.norm_apply(p["norm"], self.cfg, h)
            out, _ = S.ssm_apply(p["ssm"], self.cfg, hn, use_kernel=True)
            return h + out

        if torch.is_grad_enabled():  # training: the reference's remat_wrap(body, ...)
            body = remat_wrap(body, self.cfg.remat_policy)
        for p in params["layers"]:
            x = body(p, x)
        return x

    def loss_fn(self, batch: Dict[str, Any],
                params: Optional[Tree] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Shifted cross-entropy (f32) + z-loss + aux, and its metrics."""
        logits, aux = self.forward(batch, params)
        targets = self._tokens(batch["tokens"])[:, 1:]
        logits = logits[:, :-1]
        mask = torch.ones(targets.shape, dtype=torch.float32, device=logits.device)
        if "loss_mask" in batch:
            lm = torch.as_tensor(batch["loss_mask"], device=logits.device)
            mask = mask * lm[:, 1:].to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        tgt_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
        nll = logz - tgt_logit
        denom = torch.clamp_min(mask.sum(), 1.0)
        ce = (nll * mask).sum() / denom
        z_loss = 1e-4 * (logz.square() * mask).sum() / denom
        loss = ce + z_loss + aux
        metrics = {"loss": loss, "ce": ce, "z_loss": z_loss, "aux_loss": aux,
                   "tokens": mask.sum()}
        return loss, metrics

    # -- decode cache ----------------------------------------------------------

    def cache_specs(self, batch: int, max_len: int) -> Dict[str, TensorSpec]:
        if self.cfg.family == "ssm":
            return S.ssm_state_specs(self.cfg, batch, self.cfg.num_layers)
        return L.init_kv_cache_specs(self.cfg, batch, max_len, self.cfg.num_layers)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for k, s in self.cache_specs(batch, max_len).items()}

    # -- prefill / decode ------------------------------------------------------

    def _decoder_pass(self, params: Tree, tokens, cache: Dict[str, torch.Tensor],
                      index: int, last_only: bool) -> torch.Tensor:
        """Consume tokens at [index, index+T), writing the cache in place."""
        tokens = self._tokens(tokens)
        b, t = tokens.shape
        x = L.embed_apply(params["embed"], self.cfg, tokens)
        if self.cfg.family == "ssm":
            h = self._ssm_pass(params, x, cache)
        else:
            positions = (index + torch.arange(t, device=tokens.device))[None, :].expand(b, t)
            h, _, _ = T.decoder_stack_apply(params["layers"], self.cfg, x,
                                            positions=positions, caches=cache,
                                            cache_index=index)
        if last_only:  # the unembedding is per position: only the last one is kept
            h = h[:, -1:]
        return self._final_logits(params, h)

    def _ssm_pass(self, params: Tree, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Run the SSM layers from the cached state; each layer writes its
        slice of the stacked state in place."""
        for i, p in enumerate(params["layers"]):
            hn = L.norm_apply(p["norm"], self.cfg, x)
            out, new = S.ssm_apply(p["ssm"], self.cfg, hn, use_kernel=True,
                                   state={"ssd": cache["ssd"][i], "conv": cache["conv"][i]})
            x = x + out
            cache["ssd"][i].copy_(new["ssd"])
            cache["conv"][i].copy_(new["conv"])
        return x

    def prefill(self, batch: Dict[str, Any], cache: Dict[str, torch.Tensor],
                params: Optional[Tree] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Fill the cache from position 0; returns (last-position logits (B,1,V), cache)."""
        params = params or self.params_tree()
        return self._decoder_pass(params, batch["tokens"], cache, 0, last_only=True), cache

    def decode_step(self, cache: Dict[str, torch.Tensor], tokens, index: int,
                    params: Optional[Tree] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Consume ``tokens`` (B,T) at position ``index`` (the current cache
        length); returns (logits (B,T,V), cache)."""
        params = params or self.params_tree()
        return self._decoder_pass(params, tokens, cache, int(index), last_only=False), cache
