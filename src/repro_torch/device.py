"""Where the port's entry points run.

Every entry point takes ``device=``.  ``None`` means the card: the port is
written for an NVIDIA H100, and a caller that wants the CPU (the tests do)
says so with ``device="cpu"``.  Without a card and without that request
`resolve_device` raises, so a run never quietly carries on on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch device an entry point runs on (``None`` → ``cuda``).

    On the first touch of the card this pins float32 matmul precision:
    TF32 keeps about three decimal digits, and the GP's float32 products
    (distance expansions, posterior means) must not run in it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; want 'cuda' or 'cpu'")
    return dev
