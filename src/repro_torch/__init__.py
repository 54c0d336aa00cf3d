"""PyTorch/CUDA port of the Ruya tuner (the JAX package `repro` is the reference).

The package mirrors the reference's module paths (`repro/core/fast_bo.py`
maps to `repro_torch/core/fast_bo.py`) and imports neither JAX nor `repro`.
Entry points take ``device=``: they run on ``cuda`` unless the caller
passes ``device="cpu"``, and raise when no card is present instead of
quietly running on the CPU (`repro_torch.device.resolve_device`).

The package ``__init__`` files are empty of imports, so that importing one
module never drags in the rest, but for those of ``configs``, ``models``
and ``parallel``, which export what the reference's do.
"""
