"""The weights of a run, drawn on the device from ``--seed``.

`layout(cfg)` names every parameter of a configuration by its dotted path in
the program's parameter tree (``layers.3.attn.wq``), with its shape and its
initialiser, as the family's reference module (`reference/<family>.py`)
lays them out; `draw` makes them with one `torch.Generator` on the device,
the normal leaves a few large draws at a time, each leaf scaled and stored
in the type it is used in: float32 for training, and for serving the
compute dtype for the weights that the program only reads in it (the
family's ``SERVED_IN_COMPUTE``, as its ``cast_weights_`` casts them).  The
same seed gives the same values, so the reference draws them again after
the program is gone.

The initialisers are this benchmark's own, of the usual kind for trained
models' starting points (not the program's): normal 0.02 for the
embedding, 1/sqrt(fan_in) for input projections, 1/sqrt(2 * layers *
fan_in) for the projections that write into the residual stream, ones for
norm scales.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

from portbench import reference

__all__ = ["draw", "iter_draw", "layout", "nest"]

_CHUNK = 1 << 28  # elements of one normal draw (1 GiB of float32)

Leaf = Tuple[str, Tuple[int, ...], str, float]  # (name, shape, init, std)


def layout(c: dict) -> List[Leaf]:
    """Every parameter of configuration ``c`` (a configuration file's
    contents), in a fixed order: its family's (`reference/<family>.py`)."""
    return reference.family(c).layout(c)


def _dtype(c: dict, name: str, served: bool) -> torch.dtype:
    last = name.rsplit(".", 1)[-1]
    if served and last in reference.family(c).SERVED_IN_COMPUTE:
        return getattr(torch, c["compute_dtype"])
    return torch.float32


def iter_draw(c: dict, seed: int, device, *, served: bool) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every parameter, drawn on ``device`` from ``seed``:
    float32 (``served=False``, training), or as served (the compute-dtype
    weights in that dtype).  The normal leaves come first, a draw of up to
    `_CHUNK` values at a time, then the rest."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    specs = layout(c)
    group: List[Leaf] = []

    def flush():
        total = sum(math.prod(s) for _, s, _, _ in group)
        flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
        off = 0
        for name, shape, _, std in group:
            n = math.prod(shape)
            yield name, flat[off:off + n].view(shape).mul_(std).to(_dtype(c, name, served),
                                                                     copy=True)
            off += n
        group.clear()

    size = 0
    for leaf in specs:
        if leaf[2] != "normal":
            continue
        if group and size + math.prod(leaf[1]) > _CHUNK:
            yield from flush()
            size = 0
        group.append(leaf)
        size += math.prod(leaf[1])
    if group:
        yield from flush()
    for name, shape, init, _ in specs:
        if init == "normal":
            continue
        if init == "ones":
            t = torch.ones(shape, device=device)
        else:
            raise ValueError(f"unknown init {init!r}")
        yield name, t.to(_dtype(c, name, served))


def draw(c: dict, seed: int, device, *, served: bool) -> Dict[str, torch.Tensor]:
    """{name: tensor} of every parameter (`iter_draw`), in `layout`'s order."""
    out = dict(iter_draw(c, seed, device, served=served))
    return {name: out[name] for name, _, _, _ in layout(c)}


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """The program's parameter tree from dotted names: dicts, and a list
    where the keys are layer indices."""
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)
