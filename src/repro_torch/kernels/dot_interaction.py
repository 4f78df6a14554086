"""DLRM pairwise dot interaction over the hand-written CUDA kernel
(``csrc/dot_interaction.cu``), the port of
``repro/kernels/dot_interaction.py``.

:func:`dot_interaction` takes the plain version in ``kernels/ref.py`` for a
CPU tensor and launches the kernel (:func:`interact`) for a CUDA one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel

DOT = Kernel("dot_interaction.cu", "dot_interaction_f32_launch",
             [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p])

# shared memory one block may use on Hopper (opt-in dynamic maximum)
MAX_SMEM_BYTES = 232_448


def interact(z: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: z (B, F, S) contiguous float32 on the card ->
    (B, F(F-1)/2) float32.  One sample's (F, S+1) padded features must fit
    in shared memory."""
    if z.device.type != "cuda":
        raise RuntimeError(f"interact launches a CUDA kernel; got a tensor "
                           f"on {z.device}")
    if z.dtype != torch.float32:
        raise NotImplementedError(
            f"the CUDA interaction kernel takes float32, got {z.dtype} "
            "(bf16: ROADMAP B-section)")
    if z.dim() != 3 or not z.is_contiguous():
        raise ValueError(f"z must be a contiguous (B, F, S) tensor, got "
                         f"shape {tuple(z.shape)}")
    b, f, s = z.shape
    if f * (s + 1) * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"(F, S) = ({f}, {s}) does not fit one block's "
                         f"shared memory ({MAX_SMEM_BYTES} B)")
    out = torch.empty((b, f * (f - 1) // 2), dtype=z.dtype, device=z.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(z.device):
        DOT(z.data_ptr(), out.data_ptr(), b, f, s,
            torch.cuda.current_stream(z.device).cuda_stream)
    return out


def dot_interaction(z: torch.Tensor, *, batch_tile: int = 128):
    """z: (B, F, S) -> (B, F(F-1)/2).  ``batch_tile`` is the TPU grid tile
    and has no counterpart (the kernel runs one block per sample)."""
    if z.device.type == "cpu":
        return ref.dot_interaction_ref(z)
    return interact(z)
