"""Serving from the command line (port of `repro/launch/serve.py`).

    python -m repro_torch.launch.serve --arch <id> [--smoke] [--device cpu]

for any of the ten architectures of `repro_torch.configs`.

Builds the model with random weights drawn from ``--seed`` on the device
(the card unless ``--device cpu``), then prefills a batch of Zipf prompts
from `data.make_batch` and decodes greedily, reporting prefill latency and
decode throughput.  For serving, the weights the model reads only in the
compute dtype are cast to it once, in place (`Model.cast_weights_`): the
same numbers as a cast at every use, and half the memory of float32.
``--max-len`` sizes the KV caches (an SSM's state is O(1) in sequence
length).  As in the reference, a VLM request's sequence is its
``--prompt-len`` text tokens after the config's ``num_patch_tokens``
patches, and an encoder-decoder request carries the encoder's frames; both
stubs come from `make_batch`.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from repro_torch import configs as C
from repro_torch.data.pipeline import make_batch
from repro_torch.device import DeviceLike
from repro_torch.models.model import Model
from repro_torch.runtime.decode_loop import ServeLoop
from repro_torch.runtime.steps import make_serve_steps

__all__ = ["build_model", "main", "requests", "serve_loop"]


def build_model(arch: str, *, smoke: bool = False, seed: int = 0, device: DeviceLike = None,
                num_layers: Optional[int] = None) -> Model:
    """The architecture's model with random weights from ``seed``, drawn on
    ``device``, cast for serving (`Model.cast_weights_`).  ``num_layers``
    keeps the first that many layers (full width, reduced depth), for a
    model that does not fit the device whole."""
    cfg = (C.smoke(arch) if smoke else C.get(arch)).model
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    return Model(cfg, device=device, seed=seed).cast_weights_()


def serve_loop(model: Model, batch: int, max_len: int, *, eos_id: int = -1) -> ServeLoop:
    """A `ServeLoop` over ``model`` with a fresh (batch, max_len) cache per request batch."""
    prefill, decode = make_serve_steps(model)
    return ServeLoop(prefill_step=prefill, decode_step=decode, params=model.params_tree(),
                     init_cache=lambda: model.init_cache(batch, max_len), eos_id=eos_id)


def requests(model: Model, batch: int, seq_len: int, *, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A batch of Zipf prompts from `make_batch`, on the model's device,
    with its modality stubs (a VLM's ``patches``, which take the first
    ``num_patch_tokens`` of the ``seq_len`` positions; an encoder-decoder's
    ``frames``)."""
    req = make_batch(model.cfg, batch, seq_len, seed=seed)
    return {k: torch.as_tensor(v, device=model.device) for k, v in req.items()
            if k != "loss_mask"}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    model = build_model(args.arch, smoke=args.smoke, seed=args.seed, device=args.device)
    loop = serve_loop(model, args.batch, args.max_len)
    seq = args.prompt_len
    if model.cfg.family == "vlm":
        seq += model.cfg.num_patch_tokens
    out = loop.generate(requests(model, args.batch, seq, seed=args.seed),
                        args.max_new_tokens, echo_metrics=True)
    m = out["metrics"]
    print(f"[serve] device={model.device} batch={args.batch} prompt={args.prompt_len} "
          f"new={m['decoded']} prefill={m['prefill_s']*1e3:.1f}ms "
          f"decode={m['decode_s']*1e3:.1f}ms ({m['tokens_per_s']:.0f} tok/s)")
    print("[tokens]", out["tokens"][0][:16].tolist())


if __name__ == "__main__":
    main()
