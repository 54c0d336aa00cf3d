"""Batched serving loop (port of `repro/runtime/decode_loop.py`).

Requests (prompts) are grouped into fixed-size batches, prefilled once,
then decoded greedily token by token.  A VLM batch's P patches fill the
cache before its T text tokens, so decoding starts at position P + T.
Per-request stop handling masks finished rows (EOS); the loop reports
prefill time and decode throughput.

The cache is updated in place by each step, which takes the place of the
reference's ``donate_argnums``: one buffer per batch, no copy per token.
Times are host clocks around work that ends in a device-to-host copy of
the new tokens, so they include the device's work.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch

__all__ = ["ServeLoop"]


@dataclasses.dataclass
class ServeLoop:
    prefill_step: Callable  # (params, batch, cache) -> (logits, cache)
    decode_step: Callable  # (params, cache, tokens, index) -> (logits, cache)
    params: Any
    init_cache: Callable[[], Any]  # fresh zeroed cache per batch
    eos_id: int = 1

    @torch.inference_mode()
    def generate(
        self,
        batch: Dict[str, torch.Tensor],  # {"tokens": (B,T), + modality stubs}
        max_new_tokens: int,
        *,
        echo_metrics: bool = False,
    ) -> Dict[str, Any]:
        cache = self.init_cache()
        b, t = batch["tokens"].shape
        offset = t + (batch["patches"].shape[1] if "patches" in batch else 0)

        t0 = time.monotonic()
        logits, cache = self.prefill_step(self.params, batch, cache)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        host_tok = next_tok.cpu().numpy()
        prefill_s = time.monotonic() - t0

        out_tokens: List[np.ndarray] = [host_tok]
        finished = np.zeros((b,), bool)
        t1 = time.monotonic()
        index = offset
        for _ in range(max_new_tokens - 1):
            logits, cache = self.decode_step(self.params, cache, next_tok, index)
            next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            index += 1
            host_tok = next_tok.cpu().numpy()
            finished |= host_tok[:, 0] == self.eos_id
            out_tokens.append(host_tok)
            if finished.all():
                break
        decode_s = time.monotonic() - t1

        tokens = np.concatenate(out_tokens, axis=1)
        result: Dict[str, Any] = {"tokens": tokens}
        if echo_metrics:
            result["metrics"] = {
                "prefill_s": prefill_s,
                "decode_s": decode_s,
                "decoded": int(tokens.shape[1]),
                "tokens_per_s": tokens.size / max(decode_s, 1e-9),
            }
        return result
