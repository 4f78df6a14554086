"""RWKV-6 WKV over the hand-written CUDA kernel (``csrc/rwkv6_wkv.cu``), the
port of ``repro/kernels/rwkv6_wkv.py``.

:func:`rwkv6_wkv` takes the plain chunked version in ``kernels/ref.py`` for
a CPU tensor and launches the kernel (:func:`wkv`) for a CUDA one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel

WKV = Kernel("rwkv6_wkv.cu", "rwkv6_wkv_launch",
             [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p])

HEAD_SIZE = 64


def launch_key(b: int, s: int, h: int) -> tuple:
    """What ``WKV.by_key`` counts a launch under: its (B, S, H)."""
    return (b, s, h)


def wkv(r, k, v, logw, u, state0):
    """The CUDA kernel: r, k, logw (B, S, H, 64), v (B, S, H, 64),
    u (H, 64) and state0 (B, H, 64, 64), contiguous and float32 on one card
    (u may be any float type: it is taken to float32) -> (out (B, S, H, 64),
    final state (B, H, 64, 64)), both float32.  Any S: the kernel masks its
    ragged last chunk.  Each launch is counted on ``WKV`` under
    :func:`launch_key`."""
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, K), got shape {tuple(r.shape)}")
    b, s, h, kk = r.shape
    vv = v.shape[-1] if v.dim() == 4 else -1
    if kk != HEAD_SIZE or vv != HEAD_SIZE:
        raise NotImplementedError(
            f"the CUDA WKV kernel takes K = V = {HEAD_SIZE}, got K {kk}, "
            f"V {vv}")
    want = {"r": (b, s, h, kk), "k": (b, s, h, kk), "v": (b, s, h, vv),
            "logw": (b, s, h, kk), "u": (h, kk), "state0": (b, h, kk, vv)}
    args = {"r": r, "k": k, "v": v, "logw": logw, "u": u.float(),
            "state0": state0}
    for name, x in args.items():
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, want "
                             f"{want[name]}")
    for name, x in args.items():
        if x.dtype != torch.float32:
            raise NotImplementedError(
                f"the CUDA WKV kernel takes float32, {name} is {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in args.items():
        if x.device.type != "cuda" or x.device != r.device:
            raise RuntimeError(f"wkv launches a CUDA kernel on one card; "
                               f"{name} is on {x.device}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    out = torch.empty_like(v)
    state = torch.empty_like(state0)
    if out.numel() == 0:
        return out, state.copy_(state0)
    with torch.cuda.device(r.device):
        WKV(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            args["u"].data_ptr(), state0.data_ptr(), out.data_ptr(),
            state.data_ptr(), b, s, h,
            torch.cuda.current_stream(r.device).cuda_stream,
            key=launch_key(b, s, h))
    return out, state


def rwkv6_wkv(r, k, v, logw, u, state0):
    """r, k, logw (B, S, H, K), v (B, S, H, V), u (H, K), state0
    (B, H, K, V) -> (out, final state).  The reference's ``chunk`` TPU tile
    has no counterpart: the kernel's own chunk is 32 tokens, and the
    function it computes is exact whatever the chunk."""
    if r.device.type == "cpu":
        return ref.rwkv6_wkv_chunked_ref(r, k, v, logw, u, state0)
    return wkv(r, k, v, logw, u, state0)
