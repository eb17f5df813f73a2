"""The state of a sharded run: one tensor per shard, each on its device.

Under `shard_map` every device runs the JAX package's integrator on its
own block. Here one process runs it once on a `Shards`, a tuple of
per-shard tensors in row-major mesh order whose arithmetic and torch
functions map over the shards. So the steppers of integrate/erk.py and
integrate/rkc.py run unchanged on a sharded state: each operation runs
shard by shard, with a tensor that is not sharded (h, the recurrence
scalars, the control state, all 0-d on the control device) copied to each
shard's device first. Reductions stay per shard (torch.sum gives a Shards
of per-shard sums); the adaptive loop's reduce_fn adds them in a fixed order
(parallel/sharded.py::make_reduce), JAX's psum. A Shards is a pytree of
its blocks, so torch.func's transforms map over it too (the IMEX stepper's
pointwise Jacobian, integrate/imex.py).
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree


def _on(x, device):
    """x on `device` when it is a tensor, else x."""
    return x.to(device) if isinstance(x, torch.Tensor) else x


class Shards:
    """A tuple of per-shard tensors (blocks) that maps arithmetic and
    torch functions over its shards."""

    __slots__ = ("blocks",)

    def __init__(self, blocks):
        self.blocks = tuple(blocks)

    def __len__(self):
        return len(self.blocks)

    def __iter__(self):
        return iter(self.blocks)

    @property
    def dtype(self):
        return self.blocks[0].dtype

    @property
    def device(self):
        """The device of shard 0, which holds the control state."""
        return self.blocks[0].device

    def map(self, fn, *others):
        """Shards(fn(block_i, other_i, ...)): each `other` a Shards (its
        block i), a tensor (copied to block i's device) or a Python value."""
        out = []
        for i, b in enumerate(self.blocks):
            args = [o.blocks[i] if isinstance(o, Shards) else _on(o, b.device)
                    for o in others]
            out.append(fn(b, *args))
        return Shards(out)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        first = next(a for a in (*args, *kwargs.values())
                     if isinstance(a, Shards))
        out = []
        for i, b in enumerate(first.blocks):
            def pick(a):
                if isinstance(a, Shards):
                    return a.blocks[i]
                return _on(a, b.device)
            out.append(func(*[pick(a) for a in args],
                            **{k: pick(v) for k, v in kwargs.items()}))
        return Shards(out)

    def _binary(self, other, op):
        return self.map(op, other)

    def __add__(self, other):
        return self._binary(other, lambda a, b: a + b)

    def __radd__(self, other):
        return self._binary(other, lambda a, b: b + a)

    def __sub__(self, other):
        return self._binary(other, lambda a, b: a - b)

    def __rsub__(self, other):
        return self._binary(other, lambda a, b: b - a)

    def __mul__(self, other):
        return self._binary(other, lambda a, b: a * b)

    def __rmul__(self, other):
        return self._binary(other, lambda a, b: b * a)

    def __truediv__(self, other):
        return self._binary(other, lambda a, b: a / b)

    def __rtruediv__(self, other):
        return self._binary(other, lambda a, b: b / a)

    def __neg__(self):
        return Shards(-b for b in self.blocks)


# one forward-mode product a variable over every shard at once
# (integrate/imex.py::pointwise_jacobian)
pytree.register_pytree_node(Shards, lambda s: (list(s.blocks), None),
                            lambda blocks, _: Shards(blocks))
