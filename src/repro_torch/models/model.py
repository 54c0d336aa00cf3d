"""The model facade (port of `repro/models/model.py`) over the six families:
dense, moe, ssm, hybrid, encdec and vlm.

`Model(cfg)` is an `nn.Module` that owns the parameters.  Their names
mirror the reference's tree, with each stacked "layers" axis held apart:
the reference's ``params["layers"]["attn"]["wq"][i]`` is the port's
``layers.{i}.attn.wq``.  The groups are the reference's: ``embed``,
``pos_table`` (learned positions), ``layers`` (the decoder blocks, or the
SSM family's ``norm``/``ssm`` layers), ``encoder.layers`` and
``encoder.final_norm`` (encdec), ``hybrid.mamba`` and the one
``hybrid.shared_attn`` block (hybrid), and ``final_norm``.  The entry
points are the reference's:

  * ``param_specs()``                the stacked TensorSpec tree, as the reference's
  * ``forward(batch)``               teacher-forced logits (f32) over the text
                                     positions, and the MoE aux loss
  * ``loss_fn(batch)``               shifted cross-entropy + z-loss + aux
  * ``cache_specs(batch, max_len)``  / ``init_cache(...)``: the stacked KV
                                     cache (with the encoder's ``xk``/``xv``
                                     for encdec), the SSM's recurrent state,
                                     or the hybrid's state and site caches
  * ``prefill(batch, cache)``        fill the cache from 0, last-position logits
  * ``decode_step(cache, tokens, index)``

Each takes ``params=`` to run on another tree of the same shape (the
reference's functional form); by default the module's own.  The cache is
updated in place and returned.  Batches are ``{"tokens": (B,T) ints}``
(numpy or torch), with an optional ``loss_mask``, and the modality stubs
of the reference: ``frames`` (B, S_enc, d) for encdec, run through the
encoder (at prefill, into the cross caches), and ``patches`` (B, P, d) for
the VLM, prepended to the text embeddings, so that positions run over
patches and text and a VLM prefill fills P + T cache slots.

The SSM and hybrid families send every chunked SSD call to the SSD kernel
(``use_kernel=True``): the reference's `Model` leaves `ssm_apply` at its
einsum default, and its kernel is reached only by calling
`ssd_chunked(use_kernel=True)` directly; the two routes compute the same
function (ROADMAP Queue 3).  Decode (T = 1) is the recurrent step, which
has no kernel.  With gradients enabled (training) each layer's call is
wrapped by `parallel.remat.remat_wrap` under ``cfg.remat_policy``, as the
reference wraps its scan body.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import hybrid as H
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import (TensorSpec, abstract_tree, count_params, init_tree, leaves,
                                     tree_map)
from repro_torch.parallel import spmd
from repro_torch.parallel.remat import remat_wrap

__all__ = ["STACKS", "Model", "active_params", "cache_specs", "total_params"]

Tree = Dict[str, Any]

# The families whose backbone is the decoder stack alone.
_DECODER_FAMILIES = ("dense", "moe", "vlm")

# The paths of the stacks of blocks that the reference stacks along a
# leading "layers" axis and the port holds as lists of per-layer dicts (a
# model has those of its family).
STACKS = (("layers",), ("encoder", "layers"), ("hybrid", "mamba"))


def total_params(cfg: ModelConfig) -> int:
    return count_params(_param_specs(cfg))


def active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token (all of them, but for the MoE family's
    experts outside a token's top k)."""
    n = total_params(cfg)
    if cfg.family != "moe" or cfg.moe is None:
        return n
    moe = cfg.moe
    per_expert = 3 * cfg.d_model * moe.d_ff_expert
    return n - (moe.num_experts - moe.top_k) * per_expert * cfg.num_layers


# The weights the reference reads only in the compute dtype (``.astype(cd)``
# at every use, or the embedding's gather-then-cast): `Model.cast_weights_`
# casts these and no others.  The SSM's conv taps and the MoE's router are
# read in float32.
_COMPUTE_DTYPE_WEIGHTS = frozenset({
    "embedding", "unembed", "pos_table",
    "wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo",  # attention
    "wi", "wi_gate", "wi_up", "bi",  # MLP and experts ("wo", "bo" as above)
    "wz", "wx", "wB", "wC", "wdt", "out_proj",  # SSM
})


def _layer_specs(cfg: ModelConfig) -> Tree:
    """One layer's parameter tree of the ``layers`` group."""
    if cfg.family == "ssm":
        return {"norm": L.norm_specs(cfg), "ssm": S.ssm_specs(cfg)}
    return T.block_specs(cfg, cross=cfg.family == "encdec")


def _param_specs(cfg: ModelConfig, *, stacked: bool = True) -> Tree:
    """The parameter tree: stacked over layers as the reference's, or with
    ``stacked=False`` as the port holds it (each stack a list of per-layer
    dicts)."""
    cfg.validate()
    specs: Tree = {"embed": L.embedding_specs(cfg)}
    if cfg.pos_emb == "learned":
        if cfg.max_position <= 0:
            raise ValueError("learned position embeddings need max_position > 0")
        specs["pos_table"] = TensorSpec((cfg.max_position, cfg.d_model), cfg.pdtype,
                                        (None, "embed"), init="normal", init_scale=0.02)
    if cfg.family == "encdec":
        specs["encoder"] = T.encoder_stack_specs(cfg, stacked=stacked)
    if cfg.family in _DECODER_FAMILIES + ("encdec", "ssm"):
        specs["layers"] = (T.stack_specs(_layer_specs(cfg), cfg.num_layers) if stacked
                           else [_layer_specs(cfg) for _ in range(cfg.num_layers)])
    elif cfg.family == "hybrid":
        specs["hybrid"] = H.hybrid_specs(cfg, stacked=stacked)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    specs["final_norm"] = L.norm_specs(cfg)
    return specs


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, TensorSpec]:
    """The decode cache's tree (`Model.cache_specs`), from the config alone."""
    if cfg.family == "ssm":
        return S.ssm_state_specs(cfg, batch, cfg.num_layers)
    if cfg.family == "hybrid":
        return H.hybrid_state_specs(cfg, batch, max_len)
    specs = L.init_kv_cache_specs(cfg, batch, max_len, cfg.num_layers)
    if cfg.family == "encdec":
        shape = (cfg.num_layers, batch, cfg.encoder.source_len, cfg.num_kv_heads, cfg.head_dim)
        axes = ("layers", "batch", None, "kv_heads", "head_dim")
        specs["xk"] = TensorSpec(shape, cfg.cdtype, axes)
        specs["xv"] = TensorSpec(shape, cfg.cdtype, axes)
    return specs


def _unstacked_specs(cfg: ModelConfig) -> Tree:
    """The port's own parameter tree: one dict per layer."""
    return _param_specs(cfg, stacked=False)


class _Group(nn.Module):
    """A dict node that holds both tensors and subtrees (the MoE block:
    router and experts beside the shared expert), in the tree's order."""

    def __init__(self, tree: Tree):
        super().__init__()
        self._keys = tuple(tree)
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))
            else:
                self.add_module(k, _as_module(v))

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def items(self):
        return [(k, getattr(self, k)) for k in self._keys]


def _as_module(tree: Any) -> nn.Module:
    if isinstance(tree, list):
        return nn.ModuleList([_as_module(v) for v in tree])
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    if any(isinstance(v, torch.Tensor) for v in tree.values()):
        return _Group(tree)
    return nn.ModuleDict({k: _as_module(v) for k, v in tree.items()})


def _as_tree(m: nn.Module) -> Any:
    if isinstance(m, nn.ParameterDict):
        return dict(m.items())
    if isinstance(m, nn.ModuleList):
        return [_as_tree(v) for v in m]
    return {k: v if isinstance(v, torch.Tensor) else _as_tree(v) for k, v in m.items()}


class Model(nn.Module):
    """A model of any of the six families, with its parameters.

    ``params``: a tree like `params_tree` gives (e.g. from
    `convert.params_from_jax`), moved to ``device``; otherwise the spec's
    initializers draw them on ``device`` from a `torch.Generator` there,
    seeded with ``seed``.  ``device=None`` is the card (`resolve_device`);
    on ``"meta"`` the parameters are shapes only, for a model whose steps
    take their parameters as arguments (`launch.build`).  A batch's
    DTensors stay where they are.
    """

    def __init__(self, cfg: ModelConfig, *, params: Optional[Tree] = None,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        specs = _unstacked_specs(cfg)
        dev = torch.device("meta") if device == "meta" else resolve_device(device)
        self.cfg = cfg
        if params is None and dev.type == "meta":
            params = abstract_tree(specs)
        elif params is None:
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
        self._groups = tuple(specs)  # the tree's top-level groups, in the spec's order
        for group in self._groups:
            value = params[group]
            if isinstance(value, torch.Tensor):
                setattr(self, group, nn.Parameter(value, requires_grad=False))
            else:
                setattr(self, group, _as_module(value))

    # -- parameters ---------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.final_norm["scale"].device

    def param_specs(self, *, stacked: bool = True) -> Tree:
        """The TensorSpec tree, stacked over layers as the reference's, or
        with ``stacked=False`` as the module holds it (a list per stack)."""
        return _param_specs(self.cfg, stacked=stacked)

    def total_params(self) -> int:
        return total_params(self.cfg)

    def params_tree(self) -> Tree:
        """The module's parameters as a nested dict, each stack a list."""
        out = {}
        for group in self._groups:
            m = getattr(self, group)
            out[group] = m if isinstance(m, torch.Tensor) else _as_tree(m)
        return out

    @torch.no_grad()
    def cast_weights_(self) -> "Model":
        """Cast, in place, every weight the model only ever reads in the
        compute dtype (`_COMPUTE_DTYPE_WEIGHTS`: the projections, the
        experts, the embedding and position tables) to that dtype.  The
        outputs stay the same numbers, each forward skips its per-use
        casts, and those weights take half the memory of float32.  The rest
        stay in their dtype: norm scales, the MoE router, the SSM's conv
        taps, decay rates and skip weights are read in float32."""
        for name, p in self.named_parameters():
            if name.rsplit(".", 1)[-1] in _COMPUTE_DTYPE_WEIGHTS:
                p.data = p.data.to(self.cfg.cdtype)
        return self

    # -- helpers ------------------------------------------------------------

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, DTensor):
            return tokens.long()
        return torch.as_tensor(tokens, device=self.device).long()

    def _stub(self, batch: Dict[str, Any], key: str) -> torch.Tensor:
        if isinstance(batch[key], DTensor):
            return batch[key]
        return torch.as_tensor(batch[key], device=self.device)

    def _num_patches(self, batch: Dict[str, Any]) -> int:
        if self.cfg.family == "vlm" and "patches" in batch:
            return int(batch["patches"].shape[1])
        return 0

    def _embed_inputs(self, params: Tree, batch: Dict[str, Any], tokens: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
        """Token embeddings, after the VLM's patches, plus learned positions."""
        cfg = self.cfg
        x = L.embed_apply(params["embed"], cfg, tokens)
        if self._num_patches(batch):
            x = torch.cat([self._stub(batch, "patches").to(cfg.cdtype), x], dim=1)
        if cfg.pos_emb == "learned":
            x = x + L.cast_gather(params["pos_table"], positions, cfg.cdtype)
        return x

    def _inputs(self, params: Tree, batch: Dict[str, Any],
                index: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(embedded inputs, positions) for ``batch`` at [index, index + P + T)."""
        tokens = self._tokens(batch["tokens"])
        b, t = tokens.shape
        t = t + self._num_patches(batch)
        positions = (index + torch.arange(t, device=tokens.device))[None, :].expand(b, t)
        return self._embed_inputs(params, batch, tokens, positions), positions

    def _final_logits(self, params: Tree, h: torch.Tensor) -> torch.Tensor:
        h = L.norm_apply(params["final_norm"], self.cfg, h)
        return L.unembed_apply(params["embed"], self.cfg, h)

    # -- forward (teacher-forced) --------------------------------------------

    def forward(self, batch: Dict[str, Any],
                params: Optional[Tree] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits (B,T,V) f32 aligned with batch["tokens"], aux loss)."""
        params = params or self.params_tree()
        cfg = self.cfg
        x, positions = self._inputs(params, batch, 0)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family in _DECODER_FAMILIES:
            h, aux, _ = T.decoder_stack_apply(params["layers"], cfg, x, positions=positions)
        elif cfg.family == "encdec":
            enc = T.encoder_stack_apply(params["encoder"], cfg, self._stub(batch, "frames"))
            h, aux, _ = T.decoder_stack_apply(params["layers"], cfg, x, positions=positions,
                                              cross_source=enc)
        elif cfg.family == "ssm":
            h = self._ssm_forward(params, x)
        else:
            h, _ = H.hybrid_apply(params["hybrid"], cfg, x, positions=positions)
        # The logits cover the text positions; the norm and the unembedding
        # are per position, so the patches' rows are dropped first.
        h = h[:, self._num_patches(batch):]
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
        tokens = self._tokens(batch["tokens"])
        lm = batch.get("loss_mask")
        if isinstance(logits, DTensor):
            # Shift the targets, not the logits: a slice of sequence-sharded
            # logits would gather them.  Position T-1 has no target (mask 0).
            t = tokens.shape[1]
            targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
            keep = (torch.arange(t, device=logits.device) < t - 1).to(torch.float32)
            mask = torch.ones_like(tokens, dtype=torch.float32) * keep
            if lm is not None:
                mask = mask * torch.cat([lm[:, 1:], lm[:, :1]], dim=1).to(torch.float32)
        else:
            targets = tokens[:, 1:]
            logits = logits[:, :-1]
            mask = torch.ones(targets.shape, dtype=torch.float32, device=logits.device)
            if lm is not None:
                lm = torch.as_tensor(lm, device=logits.device)
                mask = mask * lm[:, 1:].to(torch.float32)
        logz = spmd.logsumexp_last(logits)  # over vocab shards without gathering them
        tgt_logit = spmd.pick_last(logits, targets)
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
        return cache_specs(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for k, s in self.cache_specs(batch, max_len).items()}

    # -- prefill / decode ------------------------------------------------------

    def _decoder_pass(self, params: Tree, batch: Dict[str, Any], cache: Dict[str, torch.Tensor],
                      index: int, last_only: bool) -> torch.Tensor:
        """Consume the batch at [index, index + P + T), writing the cache in place."""
        cfg = self.cfg
        x, positions = self._inputs(params, batch, index)
        if cfg.family in _DECODER_FAMILIES + ("encdec",):
            cross = ({"k": cache["xk"], "v": cache["xv"]} if cfg.family == "encdec"
                     else None)
            h, _, _ = T.decoder_stack_apply(params["layers"], cfg, x, positions=positions,
                                            caches={"k": cache["k"], "v": cache["v"]},
                                            cache_index=index, cross_caches=cross)
        elif cfg.family == "ssm":
            h = self._ssm_pass(params, x, cache)
        else:
            h, _ = H.hybrid_apply(params["hybrid"], cfg, x, positions=positions, state=cache,
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
        """Fill the cache from position 0; returns (last-position logits (B,1,V), cache).
        For encdec the encoder runs here and fills the cross K/V caches."""
        params = params or self.params_tree()
        if self.cfg.family == "encdec":
            enc = T.encoder_stack_apply(params["encoder"], self.cfg, self._stub(batch, "frames"))
            _build_cross_caches(params["layers"], self.cfg, enc, cache)
        return self._decoder_pass(params, batch, cache, 0, last_only=True), cache

    def decode_step(self, cache: Dict[str, torch.Tensor], tokens, index: int,
                    params: Optional[Tree] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Consume ``tokens`` (B,T) at position ``index`` (the current cache
        length, patches included); returns (logits (B,T,V), cache)."""
        params = params or self.params_tree()
        return self._decoder_pass(params, {"tokens": tokens}, cache, int(index),
                                  last_only=False), cache


def _build_cross_caches(layers, cfg: ModelConfig, enc: torch.Tensor,
                        cache: Dict[str, torch.Tensor]) -> None:
    """Project the encoder's output through every decoder layer's cross K/V,
    into ``cache["xk"]`` / ``cache["xv"]`` in place."""
    cd = cfg.cdtype
    for i, p in enumerate(layers):
        ca = p["cross_attn"]
        k = spmd.project("bsd,dhk->bshk", enc, ca["wk"].to(cd))
        v = spmd.project("bsd,dhk->bshk", enc, ca["wv"].to(cd))
        if "bk" in ca:
            k = k + ca["bk"].to(cd)
            v = v + ca["bv"].to(cd)
        cache["xk"][i].copy_(k)
        cache["xv"][i].copy_(v)
