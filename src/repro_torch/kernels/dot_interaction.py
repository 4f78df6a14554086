"""DLRM pairwise dot interaction over the hand-written CUDA kernel
(``csrc/dot_interaction.cu``), the port of
``repro/kernels/dot_interaction.py``.

:func:`dot_interaction` takes the plain version in ``kernels/ref.py`` for a
CPU tensor and launches the kernel (:func:`interact`) for a CUDA one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import Kernel

DOT = Kernel("dot_interaction.cu", "dot_interaction_f32_launch",
             [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p])
DOT_BF16 = Kernel("dot_interaction.cu", "dot_interaction_bf16_launch",
                  DOT.argtypes)
# the entry point that takes features of each type
DOTS = {torch.float32: DOT, torch.bfloat16: DOT_BF16}

# shared memory one block may use on Hopper (opt-in dynamic maximum)
MAX_SMEM_BYTES = 232_448


def launch_key(b: int, f: int, s: int) -> tuple:
    """What ``DOT.by_key`` (and ``DOT_BF16.by_key``) counts a launch
    under: its (B, F, S)."""
    return (b, f, s)


def kparts(f: int, s: int) -> int:
    """The threads that share one 2 x 2 tile's features in the launcher's
    float4 schedule (S a multiple of 4; f32 and bf16 alike),
    ``ref.dot_interaction_split_ref``'s ``kparts``, read from the built
    library."""
    fn = _build.library("dot_interaction.cu").dot_interaction_kparts
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return int(fn(f, s))


def interact(z: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: z (B, F, S) contiguous float32 or bf16 on the card
    -> (B, F(F-1)/2) in z's type.  bf16 features are staged widened to f32
    and each dot rounded once to bf16.  One sample's padded features,
    (F + 1) rows of at most S + 4 floats (f32 for either type), must fit
    in shared memory."""
    if z.device.type != "cuda":
        raise RuntimeError(f"interact launches a CUDA kernel; got a tensor "
                           f"on {z.device}")
    kernel = DOTS.get(z.dtype)
    if kernel is None:
        raise ValueError(f"the CUDA interaction kernel takes float32 or "
                         f"bf16, got {z.dtype}")
    if z.dim() != 3 or not z.is_contiguous():
        raise ValueError(f"z must be a contiguous (B, F, S) tensor, got "
                         f"shape {tuple(z.shape)}")
    b, f, s = z.shape
    if (f + 1) * (s + 4) * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"(F, S) = ({f}, {s}) does not fit one block's "
                         f"shared memory ({MAX_SMEM_BYTES} B)")
    out = torch.empty((b, f * (f - 1) // 2), dtype=z.dtype, device=z.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(z.device):
        kernel(z.data_ptr(), out.data_ptr(), b, f, s,
            torch.cuda.current_stream(z.device).cuda_stream,
            key=launch_key(b, f, s))
    return out


def dot_interaction(z: torch.Tensor, *, batch_tile: int = 128):
    """z: (B, F, S) -> (B, F(F-1)/2).  ``batch_tile`` is the TPU grid tile
    and has no counterpart (the kernel runs one block per sample)."""
    if z.device.type == "cpu":
        return ref.dot_interaction_ref(z)
    return interact(z)
