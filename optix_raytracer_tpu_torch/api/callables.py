"""Callable program tables: `optixDirectCall` / `optixContinuationCall`
(counterpart of `api/callables.py`).

The reference registers direct and continuation callables and dispatches
them by an SBT index at run time (`optixCallablePrograms.cu:123,138`, group
setup `optixCallablePrograms.cpp:434-444`). Here the index is a tensor on
the device, a scalar or one per lane; `direct_call` evaluates every
callable on the arguments and keeps, lane by lane, the one the index names
(clamped to the table, as lax.switch clamps): branchless, like the
reference's lax.switch under vmap, and no host read of the index, so
rewriting the index re-dispatches without a sync.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


class CallableTable:
    def __init__(self, callables: Sequence[Callable] = ()):
        self._fns = list(callables)

    def add(self, fn: Callable) -> int:
        """Register a callable; returns its SBT index."""
        self._fns.append(fn)
        return len(self._fns) - 1

    def __len__(self):
        return len(self._fns)

    def direct_call(self, index, *args):
        """`optixDirectCall<Ret>(sbt_index, args...)`: `index` an integer
        tensor of the lanes' batch shape (or a scalar); every callable
        returns the same shape, whose leading dimensions are the index's."""
        if not self._fns:
            raise ValueError("empty callable table")
        index = torch.clamp(torch.as_tensor(index), 0, len(self._fns) - 1)
        out = None
        for k, fn in enumerate(self._fns):
            val = fn(*args)
            if out is None:
                out = val
                continue
            sel = (index == k).to(val.device)
            sel = sel.reshape(sel.shape + (1,) * (val.ndim - sel.ndim))
            out = torch.where(sel, val, out)
        return out

    # Continuation callables dispatch alike; the distinction in the
    # reference is the driver's stack scheduling (optix_device.h:1484).
    continuation_call = direct_call
