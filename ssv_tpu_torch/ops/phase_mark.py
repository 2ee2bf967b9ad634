"""The train step's phase marks on the card (`csrc/phase_mark.cu`).

`phase_mark(index, column, pos, stamps)` launches the mark kernel
`ssv_mark_<MARKS[index]>` on the current stream, which writes the card's
`%globaltimer` (ns) into `stamps[pos, column]`, `pos` read on the device;
inside a capture it becomes a node of the graph, replayed with it. It has
no plain version to fall back to: a mark is a timestamp of the card, so on
any other device it does nothing. `utils/trace.py` places the marks and
reads the stamps.
"""

from __future__ import annotations

import ctypes

import torch


def phase_mark(index: int, column: int, pos: torch.Tensor, stamps: torch.Tensor) -> None:
    """Writes mark `index` of the step at `pos` into column `column` of
    `stamps`, (steps, the step's marks) int64 on the card (module
    docstring)."""
    if stamps.device.type != "cuda":
        return
    if (pos.device != stamps.device or pos.dtype != torch.int64 or pos.numel() != 1
            or stamps.dtype != torch.int64 or stamps.dim() != 2 or not stamps.is_contiguous()):
        raise ValueError(f"phase_mark: pos {pos.dtype} {tuple(pos.shape)} on {pos.device}, "
                         f"stamps {stamps.dtype} {tuple(stamps.shape)} on {stamps.device}")
    with torch.cuda.device(stamps.device):
        err = _library().ssv_phase_mark(
            index, column, ctypes.c_void_p(pos.data_ptr()), ctypes.c_void_p(stamps.data_ptr()),
            stamps.shape[0], stamps.shape[1],
            ctypes.c_void_p(torch.cuda.current_stream(stamps.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"phase mark {index} launch failed: CUDA error {err}")


def _library():
    from .build import load
    lib = load("phase_mark")
    if lib.ssv_phase_mark.argtypes is None:
        lib.ssv_phase_mark.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
        lib.ssv_phase_mark.restype = ctypes.c_int
    return lib
