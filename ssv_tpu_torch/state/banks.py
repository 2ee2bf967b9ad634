"""Ring buffers of feature rows on the device (port of ssv_tpu/state/banks.py:
`RingBuffer`, `ring_push`).

MoCo's key queue and SwAV's feature bank are each a fixed (size, dim)
float32 table and a write pointer, both buffers of a small module, so they
sit in `TrainState.extra` and a checkpoint saves and restores them with the
rest of the state. A push is one index write at (ptr + arange(n)) % size.
PIRL's per-sample bank (`SampleBank`) comes with PIRL.
"""

from __future__ import annotations

import torch
from torch import nn


class RingBuffer(nn.Module):
    """Fixed-size FIFO of feature rows, zero at the start, and its write
    pointer."""

    def __init__(self, size: int, dim: int):
        super().__init__()
        self.register_buffer("data", torch.zeros(size, dim, dtype=torch.float32))
        self.register_buffer("ptr", torch.zeros((), dtype=torch.int64))


@torch.no_grad()
def ring_push(buf: RingBuffer, rows: torch.Tensor) -> RingBuffer:
    """Writes `rows` at the pointer, wrapping, in place; a batch may straddle
    the end or exceed the size (then the last writes of a slot win, as in
    the JAX scatter), and the pointer advances by n mod size."""
    n, size = rows.shape[0], buf.data.shape[0]
    idx = (buf.ptr + torch.arange(n, device=buf.data.device)) % size
    if n > size:
        # an index write with repeated indices keeps no defined winner: keep
        # only each slot's last row, the one the JAX scatter leaves
        idx, rows = idx[n - size:], rows[n - size:]
    buf.data[idx] = rows.to(buf.data.dtype)
    buf.ptr.copy_((buf.ptr + n) % size)
    return buf
