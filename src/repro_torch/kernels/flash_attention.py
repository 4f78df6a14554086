"""Flash attention forward over the hand-written CUDA kernel
(``csrc/flash_attention.cu``), the port of
``repro/kernels/flash_attention.py``.

:func:`flash_attention` takes the plain version in ``kernels/ref.py`` for a
CPU tensor and launches the kernel (:func:`attend`) for a CUDA one.  The
kernel takes any head dim.  Its bodies up to 256 are built for the head
dims in :data:`HEAD_DIMS` (phi-3-mini's 96 among them); any other head dim
up to the largest (the smoke configs' 8) is zero-padded to the next built
one by :func:`pad_head_dim`, which changes no score, and the output sliced
back.  Past 256 one body per type streams the depth in 64-column boxes
(``ref.WIDE_DEPTH``) and cuts the output into slices of columns, one a
block (``ref.WIDE_SLICE``, 256, in bf16 and f16; 192 in f32); the columns
past hd read as zeros, so a row is copied padded only to a multiple of
:data:`WIDE_ALIGN` (16-byte rows for TMA and cp.async).  It takes
float32, bfloat16 and float16 (:data:`DTYPES`): bf16 and f16 run the same
tensor-core bodies.

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

# The head dims the kernel is built for, and the body each runs in bf16 and
# f16 (each body templated on the 16-bit type): 16, 32, 64, 80 and 96 the
# warp-specialised wgmma body (flash_wgmma_ws: a producer warp, two
# consumer warpgroups taking turns; columns past 64 a second TMA box, and
# at 16 and 32 the whole row one narrow box over 64-key tiles, two blocks
# an SM), 128 and 256 wgmma with thread 0 as producer (flash_wgmma); f32
# runs every one on the tensor cores in 3xTF32, three TF32 products for
# each f32 one (flash_3xtf32); past 256 the wide bodies (flash_wgmma_wide,
# flash_3xtf32_wide) at any multiple of WIDE_ALIGN
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
WIDE_ALIGN = 8
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def launch_key(h: int, kh: int, hd: int, window: int,
               causal: bool = True, dtype=torch.bfloat16) -> tuple:
    """What ``FLASH.by_key`` counts a launch under: the head shape, the
    window (0 for a global layer), whether the mask is causal (whisper's
    encoder is not) and the name of the inputs' type (a ``torch.dtype`` or
    a config's ``dtype`` string; the key holds the string, so it goes into
    JSON as it is)."""
    return (h, kh, hd, window, bool(causal),
            str(dtype).removeprefix("torch."))


def padded_head_dim(hd: int) -> int:
    """The head dim a head dim runs at: up to 256 the least of
    :data:`HEAD_DIMS` at or above it, past 256 the next multiple of
    ``ref.WIDE_DEPTH`` (the wide bodies' depth box)."""
    for built in HEAD_DIMS:
        if hd <= built:
            return built
    return -(-hd // ref.WIDE_DEPTH) * ref.WIDE_DEPTH


def row_width(hd: int) -> int:
    """The width q, k and v are laid out at for the launch: up to 256
    :func:`padded_head_dim`, past it the next multiple of
    :data:`WIDE_ALIGN` (the tensor maps zero-fill the rest of the depth)."""
    if hd <= HEAD_DIMS[-1]:
        return padded_head_dim(hd)
    return -(-hd // WIDE_ALIGN) * WIDE_ALIGN


def pad_head_dim(q, k, v):
    """(q, k, v) with their head dim zero-padded to :func:`row_width` (8 ->
    16, 24 -> 32, 88 -> 96, 160 -> 256, 300 -> 304), contiguous, and the
    scale of the true head dim (``hd ** -0.5``); a head dim that is its own
    row width passes through.  The zero columns add nothing to q . k, in
    any float type, and the output's padded columns (the zero columns of v)
    are to be sliced off."""
    hd = q.shape[-1]
    to = row_width(hd)
    if to != hd:
        q, k, v = (F.pad(x, (0, to - hd)).contiguous() for x in (q, k, v))
    return q, k, v, hd ** -0.5


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: int = 0, softcap: float = 0.0,
           return_lse: bool = False):
    """The CUDA kernel: q (B, S, H, hd), k and v (B, T, Kh, hd), contiguous,
    on one card, all of one type of :data:`DTYPES`, any hd (up to 256 one
    outside :data:`HEAD_DIMS` runs zero-padded, past 256 one that is not a
    multiple of 8: :func:`pad_head_dim`) and H a multiple of Kh -> (B, S,
    H, hd) in q's type; with ``return_lse`` also
    each query row's log-sum-exp, (B, Kh, H / Kh, S) float32 (the
    reference's ``_flash_fwd_impl`` layout, the scale of the true head
    dim).  bf16 and f16 run ``wgmma`` fed by TMA at every built hd, the
    warp-specialised body at 16 to 96 (see :data:`HEAD_DIMS`) and past 256
    (depth boxes, value slices), P rounded to the input type for P V and
    the output rounded once; f32 ``mma.sync`` in 3xTF32
    (each product as big.big + big.small + small.big of TF32 splits, within
    a few f32 ulps; ``ref.flash_attention_f32_tc_ref``).  A built
    head dim (96 included), and past 256 a multiple of 8, makes no copy of
    q, k or v.  Each launch is
    counted on ``FLASH`` under :func:`launch_key` with the true head dim
    and q's type."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in DTYPES:
            raise NotImplementedError(
                f"the CUDA flash kernel takes {tuple(DTYPES)} (ROADMAP B item "
                f"4), {name} is {x.dtype}")
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
              key=launch_key(h, kh, hd, int(window), causal, q.dtype))
    out = out if qp is q else out[..., :hd].contiguous()
    return (out, lse) if return_lse else out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, return_lse: bool = False):
    """q (B, S, H, hd), k and v (B, T, Kh, hd) -> (B, S, H, hd), and with
    ``return_lse`` the rows' log-sum-exp (B, Kh, H / Kh, S).  The
    reference's ``cq``/``ck`` TPU tiles have no counterpart: in bf16 and
    f16 the kernel tiles by 128 queries at every head dim, over 64 keys at
    hd 16 and 32, 128 at 64 and 80, 112 at 96, 128 at 128 and 64 at 256
    and past it (in f32 by 64 queries, ``ref.f32_tc_tiles``), and takes
    any S and T; a head dim up to 256 outside :data:`HEAD_DIMS` runs padded
    (8 to 16, 88 to 96), past 256 at any width."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, return_lse=return_lse)
    return attend(q, k, v, causal=causal, window=window, softcap=softcap,
                  return_lse=return_lse)
