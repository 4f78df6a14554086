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
             [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p])

HEAD_SIZE = 64
CHUNK = 32          # the kernel's tokens per chunk
STATE_PASS, OUTPUT_PASS, BOTH_PASSES = 1, 2, 3


def launch_key(b: int, s: int, h: int) -> tuple:
    """What ``WKV.by_key`` counts a launch under: its (B, S, H)."""
    return (b, s, h)


def scratch_shape(b: int, s: int, h: int) -> tuple:
    """The chunk-start states the state pass writes and the output pass
    reads: (B, H, ceil(S / 32), 64, 64) float32."""
    return (b, h, -(-s // CHUNK), HEAD_SIZE, HEAD_SIZE)


def wkv(r, k, v, logw, u, state0):
    """The CUDA kernel: r, k, logw (B, S, H, 64), v (B, S, H, 64),
    u (H, 64) and state0 (B, H, 64, 64), contiguous and float32 on one card
    (u may be any float type: it is taken to float32) -> (out (B, S, H, 64),
    final state (B, H, 64, 64)), both float32.  Any S: the kernel masks its
    ragged last chunk.  Both passes run in one launch of the entry point,
    counted once on ``WKV`` under :func:`launch_key`; the chunk-start
    states go through a scratch of :func:`scratch_shape`, freed on
    return."""
    args = check_args(r, k, v, logw, u, state0)
    if v.numel() == 0:
        return torch.empty_like(v), state0.clone()
    out, state, _ = run_passes(*args)
    return out, state


def run_passes(r, k, v, logw, u, state0, *, passes: int = BOTH_PASSES,
               buffers=None):
    """Launch the state pass, the output pass or both (``passes`` 1, 2 or
    3) on checked arguments; ``buffers`` (out, state, scratch) from an
    earlier call are reused, so the output pass alone can be run again on
    the scratch a state pass wrote.  Returns (out, state, scratch)."""
    b, s, h, _ = r.shape
    if buffers is None:
        buffers = (torch.empty_like(v), torch.empty_like(state0),
                   torch.empty(scratch_shape(b, s, h), dtype=torch.float32,
                               device=r.device))
    out, state, scratch = buffers
    with torch.cuda.device(r.device):
        WKV(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), state0.data_ptr(), out.data_ptr(),
            state.data_ptr(), scratch.data_ptr(), b, s, h, passes,
            torch.cuda.current_stream(r.device).cuda_stream,
            key=launch_key(b, s, h))
    return out, state, scratch


def check_args(r, k, v, logw, u, state0):
    """The arguments the kernel takes, u in float32; raises on any other."""
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
    return r, k, v, logw, args["u"], state0


def rwkv6_wkv(r, k, v, logw, u, state0):
    """r, k, logw (B, S, H, K), v (B, S, H, V), u (H, K), state0
    (B, H, K, V) -> (out, final state).  The reference's ``chunk`` TPU tile
    has no counterpart: the kernel's own chunk is 32 tokens, and the
    function it computes is exact whatever the chunk."""
    if r.device.type == "cpu":
        return ref.rwkv6_wkv_chunked_ref(r, k, v, logw, u, state0)
    return wkv(r, k, v, logw, u, state0)
