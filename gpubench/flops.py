"""Floating-point operations of a computation, by torch's own FLOP formulas
(convolutions and matrix products, forward and backward), counted while
it runs.

The count is taken on the benchmark's plain reference at a cell's shapes,
never on the program, so a change to the program cannot move the
yardstick.  torch's ``FlopCounterMode`` tracks modules with hooks that
``torch.autograd.grad`` with ``create_graph`` (R1) refuses, so this mode
counts at the dispatcher instead.
"""

from __future__ import annotations

from typing import Callable

from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry


class FlopCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flop = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flop += int(count(*args, **kwargs, out_val=out))
        return out


def count(fn: Callable[[], object]) -> int:
    """FLOP of one call of ``fn``."""
    with FlopCount() as fc:
        fn()
    return fc.flop
