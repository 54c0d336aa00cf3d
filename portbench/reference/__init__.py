"""Plain PyTorch references, one module a model family
(``reference/<family>.py``, found by the configuration's ``family``); they
import nothing of the program.

A family module gives what the benchmark needs of the family besides its
operation count (``counts/<family>.py``):

  * ``layout(c)``          — every parameter: (dotted name in the program's
                             tree, shape, initialiser, scale), in a fixed order;
  * ``SERVED_IN_COMPUTE``  — the last names of the weights the program reads
                             only in the compute dtype when it serves;
  * ``CACHE_KEYS``         — {the reference's state name: the program's cache
                             key} of what a prefill writes;
  * ``STATE_NUMBERS``      — {number: the state names it is the worst
                             relative error of}, for the check;
  * ``prefill(p, c, tokens, prec)`` — the last position's logits and the
                             states of ``CACHE_KEYS``;
  * ``microbatch_loss(p, c, tokens, prec, z_weight)`` — one microbatch's loss.
"""

import importlib


def family(c: dict):
    """The reference module of configuration ``c``'s family."""
    return importlib.import_module(f"portbench.reference.{c['family']}")
