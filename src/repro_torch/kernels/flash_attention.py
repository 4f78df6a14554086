"""Flash attention forward over the hand-written CUDA kernel
(``csrc/flash_attention.cu``), the port of
``repro/kernels/flash_attention.py``.

:func:`flash_attention` takes the plain version in ``kernels/ref.py`` for a
CPU tensor and launches the kernel (:func:`attend`) for a CUDA one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel

FLASH = Kernel("flash_attention.cu", "flash_attention_launch",
               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
               + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def launch_key(h: int, kh: int, hd: int, window: int) -> tuple:
    """What ``FLASH.by_key`` counts a launch under: the head shape and the
    window (0 for a global layer)."""
    return (h, kh, hd, window)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: int = 0,
           softcap: float = 0.0) -> torch.Tensor:
    """The CUDA kernel: q (B, S, H, hd), k and v (B, T, Kh, hd), contiguous,
    on one card, all float32 or all bfloat16, hd in :data:`HEAD_DIMS` and H
    a multiple of Kh -> (B, S, H, hd) in q's type.  Each launch is counted
    on ``FLASH`` under :func:`launch_key`."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in DTYPES:
            raise NotImplementedError(
                f"the CUDA flash kernel takes float32 or bfloat16, {name} is "
                f"{x.dtype}")
        if x.dim() != 4 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-d tensor, got "
                             f"shape {tuple(x.shape)}")
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not fit (B,S,H,hd), (B,T,Kh,hd)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v types differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if hd not in HEAD_DIMS:
        raise NotImplementedError(f"head dim {hd} not in {HEAD_DIMS}")
    if kh < 1 or h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} kv heads")
    if window < 0 or softcap < 0:
        raise ValueError(f"window {window} and softcap {softcap} must be >= 0")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise RuntimeError(f"attend launches a CUDA kernel on one card; "
                               f"{name} is on {x.device}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0 or t == 0:
        return out.zero_()
    with torch.cuda.device(q.device):
        FLASH(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              DTYPES[q.dtype], b, s, t, h, kh, hd, int(causal), int(window),
              hd ** -0.5, float(softcap),
              torch.cuda.current_stream(q.device).cuda_stream,
              key=launch_key(h, kh, hd, int(window)))
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B, S, H, hd), k and v (B, T, Kh, hd) -> (B, S, H, hd).  The
    reference's ``cq``/``ck`` TPU tiles have no counterpart: the kernel
    tiles by 128 queries at head dims 128 and 256 (64 below) and takes any
    S and T."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    return attend(q, k, v, causal=causal, window=window, softcap=softcap)
