"""Job-axis sharding: lockstep chunk bundles spread over devices.

Port of `repro/fleet/sharding.py`.  A lockstep chunk of at most `_CHUNK`
jobs advances one BO iteration per step on one device.  Sharding bundles up
to S chunks of one (space shape, packed capacity) group, one chunk a
device: a bundle step is one `_fleet_update` per shard, each on its shard's
device, dispatched one after another from the calling thread with no wait
for the device in between.  Searches are independent, so there are no
collectives, and the only traffic between host and devices is each chunk's
placement and the read of its rows at retirement.

Departures from the reference (ROADMAP Queue 3):

  * The reference stacks a bundle's chunks on a leading shard axis for one
    `shard_map` dispatch, so every shard has one row extent and the last is
    padded with inert dummy rows.  Here each shard holds exactly its
    members (the last shard of a bundle may be shorter) and is its own
    `FleetState` on its own device; a bundle step is S dispatches from one
    thread, not one, so sharding amortizes no host dispatch.
  * torch has one CPU device, and a box may have one card, so an explicit
    ``devices=`` list may name a device more than once (``["cpu"] * 4``,
    ``["cuda:0"] * 2``): that runs the bundle code with S shards on one
    device.  ``shard=`` as an int and ``"auto"`` count distinct CUDA devices.

Member i of a bundle lives at flat row i once the shards' rows are laid end
to end (`collapse_rows`): shards slice the member list contiguously.  A
bundle retires as a unit, when its slowest shard finishes, as in the
reference, so a warm-starting session that submits mid-flight sees the same
class-history snapshots as the reference at the same shard count.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.fast_bo import FleetState
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fleet.batched_engine import _fleet_update

__all__ = ["collapse_rows", "resolve_shard_devices", "sharded_update"]


def resolve_shard_devices(
    shard: Union[None, int, str] = None,
    devices: Optional[Sequence] = None,
    device: DeviceLike = None,
) -> Optional[Tuple[torch.device, ...]]:
    """Resolve the ``shard=``/``devices=`` switch to a device tuple.

    Returns None for the unsharded path (``shard`` unset or 1, or "auto"
    with fewer than two cards), else a tuple of at least two devices.  An
    explicit ``devices=`` list wins, and may repeat a device.
    ``shard="auto"`` takes every visible CUDA device when ``device`` (the
    session's, None meaning the card) is a CUDA device, and None on the
    CPU.  An integer asks for exactly that many CUDA devices and raises,
    naming the count, when fewer are visible.
    """
    if devices is not None:
        devs = tuple(resolve_device(d) for d in devices)
        if shard not in (None, "auto") and int(shard) != len(devs):
            raise ValueError(
                f"shard={shard!r} disagrees with {len(devs)} explicit devices"
            )
        return devs if len(devs) > 1 else None
    if shard is None:
        return None
    if shard == "auto":
        if torch.device("cuda" if device is None else device).type != "cuda":
            return None
        devs = tuple(
            torch.device("cuda", i) for i in range(torch.cuda.device_count())
        )
        return devs if len(devs) > 1 else None
    s = int(shard)
    if s < 1:
        raise ValueError(f"shard={shard!r}: want a positive shard count")
    avail = torch.cuda.device_count()
    if s > avail:
        raise ValueError(
            f"shard={s} but only {avail} CUDA device(s) are visible; pass "
            f"devices= to name the devices (a device may repeat)"
        )
    return tuple(torch.device("cuda", i) for i in range(s)) if s > 1 else None


def collapse_rows(state, n_shards: int) -> FleetState:
    """Host copy of a chunk's state, its shards' rows laid end to end:
    member i at row i, whether the chunk is one `FleetState` (``n_shards``
    1) or a bundle's list of them.  `TuningSession.reshard` snapshots every
    live row through it, mid-flight cancellation reads the victim's partial
    trials from it, and retirement reads the finished rows.  Reading waits
    for each shard's device."""
    shards = state if n_shards > 1 else (state,)
    return FleetState(*(
        np.concatenate([s[k].detach().cpu().numpy() for s in shards])
        for k in range(len(FleetState._fields))
    ))


def sharded_update(devices: Sequence, xi: float, layout: str) -> Callable:
    """The step of a bundle of ``len(devices)`` chunks: ``update(states,
    args)`` applies `_fleet_update` to shard k's state and arguments, which
    live on ``devices[k]``, for each k in turn, updating each state in
    place.  Nothing waits for a device, so the shards' work overlaps on
    distinct devices."""
    devices = tuple(devices)

    def update(states, args):
        if len(states) != len(devices) or len(args) != len(devices):
            raise ValueError(
                f"a bundle of {len(devices)} shards got {len(states)} states "
                f"and {len(args)} argument sets"
            )
        for st, a in zip(states, args):
            _fleet_update(st, *a, xi=xi, layout=layout)
        return states

    return update
