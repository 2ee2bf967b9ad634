"""Banks of feature rows on the device (port of ssv_tpu/state/banks.py).

MoCo's key queue and SwAV's feature bank are each a fixed (size, dim)
float32 table and a write pointer, both buffers of a small module, so they
sit in `TrainState.extra` and a checkpoint saves and restores them with the
rest of the state. A push is one index write at (ptr + arange(n)) % size.

PIRL's per-sample bank (`SampleBank`) holds one row per train image; rows
are written L2-normalized, updated as an EMA of normalized features, and
its negatives are drawn by a masked top-k over uniform scores. Every write
is in place under `no_grad`.
"""

from __future__ import annotations

import torch
from torch import nn

from ..objectives.losses import l2_normalize


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


class SampleBank(nn.Module):
    """One float32 row per train image, zero at the start."""

    def __init__(self, n_samples: int, dim: int):
        super().__init__()
        self.register_buffer("data", torch.zeros(n_samples, dim, dtype=torch.float32))


@torch.no_grad()
def sample_bank_set(bank: SampleBank, indices, vectors) -> SampleBank:
    """bank[indices] <- normalize(vectors)."""
    bank.data[indices] = l2_normalize(vectors)
    return bank


@torch.no_grad()
def sample_bank_update(bank: SampleBank, indices, vectors, momentum: float) -> SampleBank:
    """bank[i] <- m * bank[i] + (1 - m) * normalize(v); the row is not
    normalized again afterwards, as in the reference."""
    bank.data[indices] = momentum * bank.data[indices] + (1.0 - momentum) * l2_normalize(vectors)
    return bank


@torch.no_grad()
def sample_negatives(generator: torch.Generator, bank: SampleBank, exclude_idx,
                     num_negatives: int):
    """`num_negatives` bank rows drawn uniformly without replacement from the
    rows not in `exclude_idx`: uniform scores, -inf at the excluded rows,
    top-k."""
    scores = torch.rand(bank.data.shape[0], generator=generator, device=bank.data.device)
    # a fill on the device (an index write of a host number copies it from
    # the host, which a captured step cannot)
    scores.index_fill_(0, exclude_idx, -torch.inf)
    return bank.data[torch.topk(scores, num_negatives).indices]
