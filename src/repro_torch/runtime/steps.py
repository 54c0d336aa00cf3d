"""Step-function factories (port of `repro/runtime/steps.py`): the serving pair.

``prefill_step(params, batch, cache)`` and ``decode_step(params, cache,
tokens, index)`` keep the reference's signatures; ``params`` is a tree like
`Model.params_tree` gives.  `make_train_step` comes with the training slice
(ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from repro_torch.models.model import Model

__all__ = ["make_serve_steps"]


def make_serve_steps(model: Model):
    """(prefill_step, decode_step) pair for the serving path."""

    def prefill_step(params, batch, cache):
        return model.prefill(batch, cache, params=params)

    def decode_step(params, cache, tokens, index):
        return model.decode_step(cache, tokens, index, params=params)

    return prefill_step, decode_step
