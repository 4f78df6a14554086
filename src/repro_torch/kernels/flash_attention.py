"""Flash attention forward over the hand-written CUDA kernel
(``csrc/flash_attention.cu``), the port of
``repro/kernels/flash_attention.py``.

:func:`flash_attention` takes the plain version in ``kernels/ref.py`` for a
CPU tensor and launches the kernel (:func:`attend`) for a CUDA one.  The
kernel is built for the head dims in :data:`HEAD_DIMS`; one in
:data:`PADDED_HEAD_DIMS` (the smoke configs' 8) is zero-padded to a built
one by :func:`pad_head_dim`, which changes no score, and the output sliced
back.

The kernel is forward-only and takes no part in autograd: on the card a
call with grad enabled and an input that requires grad raises (training
goes through ``ops.FlashAttentionFn``, whose forward asks the kernel for
the rows' log-sum-exp with ``return_lse=True``).
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel

FLASH = Kernel("flash_attention.cu", "flash_attention_launch",
               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
               + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])

HEAD_DIMS = (16, 32, 64, 80, 128, 256)
# head dim -> the built head dim it is zero-padded to
PADDED_HEAD_DIMS = {8: 16}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def launch_key(h: int, kh: int, hd: int, window: int,
               causal: bool = True) -> tuple:
    """What ``FLASH.by_key`` counts a launch under: the head shape, the
    window (0 for a global layer) and whether the mask is causal (whisper's
    encoder is not)."""
    return (h, kh, hd, window, bool(causal))


def pad_head_dim(q, k, v):
    """(q, k, v) with a head dim in :data:`PADDED_HEAD_DIMS` zero-padded to
    the built one, contiguous, and the scale of the true head dim
    (``hd ** -0.5``); other head dims pass through.  The zero columns add
    nothing to q . k, and the output's padded columns (the zero columns of
    v) are to be sliced off."""
    hd = q.shape[-1]
    to = PADDED_HEAD_DIMS.get(hd, hd)
    if to != hd:
        q, k, v = (F.pad(x, (0, to - hd)).contiguous() for x in (q, k, v))
    return q, k, v, hd ** -0.5


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: int = 0, softcap: float = 0.0,
           return_lse: bool = False):
    """The CUDA kernel: q (B, S, H, hd), k and v (B, T, Kh, hd), contiguous,
    on one card, all float32 or all bfloat16, hd in :data:`HEAD_DIMS` or
    :data:`PADDED_HEAD_DIMS` and H a multiple of Kh -> (B, S, H, hd) in q's
    type; with ``return_lse`` also each query row's log-sum-exp, (B, Kh,
    H / Kh, S) float32 (the reference's ``_flash_fwd_impl`` layout, the
    scale of the true head dim).  Each launch is counted on ``FLASH`` under
    :func:`launch_key` with the true head dim."""
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
    if hd not in HEAD_DIMS and hd not in PADDED_HEAD_DIMS:
        raise NotImplementedError(f"head dim {hd} not in {HEAD_DIMS} or "
                                  f"{tuple(PADDED_HEAD_DIMS)}")
    if kh < 1 or h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} kv heads")
    if window < 0 or softcap < 0:
        raise ValueError(f"window {window} and softcap {softcap} must be >= 0")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError("the flash kernel has no backward: a tensor that "
                           "requires grad goes through "
                           "ops.FlashAttentionFn")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise RuntimeError(f"attend launches a CUDA kernel on one card; "
                               f"{name} is on {x.device}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if q.numel() == 0 or t == 0:
        out = torch.zeros_like(q)
        if not return_lse:
            return out
        # no key: m is taken as 0 and the sum clamps to 1e-30
        return out, torch.full((b, kh, h // kh, s), math.log(1e-30),
                               dtype=torch.float32, device=q.device)
    qp, kp, vp, scale = pad_head_dim(q, k, v)
    out = torch.empty_like(qp)
    lse = torch.empty((b, kh, h // kh, s), dtype=torch.float32,
                      device=q.device) if return_lse else None
    with torch.cuda.device(q.device):
        FLASH(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
              None if lse is None else lse.data_ptr(), DTYPES[q.dtype], b,
              s, t, h, kh, qp.shape[-1], int(causal), int(window), scale,
              float(softcap),
              torch.cuda.current_stream(q.device).cuda_stream,
              key=launch_key(h, kh, hd, int(window), causal))
    out = out if qp is q else out[..., :hd].contiguous()
    return (out, lse) if return_lse else out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, return_lse: bool = False):
    """q (B, S, H, hd), k and v (B, T, Kh, hd) -> (B, S, H, hd), and with
    ``return_lse`` the rows' log-sum-exp (B, Kh, H / Kh, S).  The
    reference's ``cq``/``ck`` TPU tiles have no counterpart: the kernel
    tiles by 128 queries at head dims 128 and 256 (64 below) and takes any
    S and T; head dim 8 runs padded to 16."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, return_lse=return_lse)
    return attend(q, k, v, causal=causal, window=window, softcap=softcap,
                  return_lse=return_lse)
