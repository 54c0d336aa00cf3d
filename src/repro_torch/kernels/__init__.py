"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

On the ``meta`` device, while a step is traced for its shapes and costs
(`launch.build`: the step counter of `launch.hlo_analysis` is one of
`META_WATCHERS`), a kernel op gives its output through a shape function,
`meta_call`, which tells each watcher of the call and its matrix-product
flops.  With no watcher a meta tensor is refused, as any device but the
card and the CPU.
"""

from typing import Callable, List

__all__ = ["META_WATCHERS", "meta_call"]

META_WATCHERS: List[Callable[[str, float], None]] = []


def meta_call(name: str, out, flops: float):
    """A kernel's call on meta tensors: returns ``out`` (from the kernel's
    shape function, allocating what its launch allocates) and reports
    (``name``, ``flops``) to each watcher."""
    for watch in META_WATCHERS:
        watch(name, flops)
    return out
