"""RWKV-6 WKV over the hand-written CUDA kernel (``csrc/rwkv6_wkv.cu``), the
port of ``repro/kernels/rwkv6_wkv.py``.

:func:`rwkv6_wkv` takes the plain chunked version in ``kernels/ref.py`` for
a CPU tensor and launches the kernel (:func:`wkv`) for a CUDA one.  The
kernel is forward-only: on the card a call with grad enabled and an input
that requires grad raises (training goes through ``ops.Rwkv6WkvFn``).

The kernel's domain is the reference kernel's: any K and V >= 1; r, k
and v in one type of :data:`DTYPES`, logw in that type or in float32.  It
widens every input to float32 as it reads it and rounds the output once to
r's type; the state is float32.  Other mixes of the types of
:data:`DTYPES` are widened to float32 before the launch; a type outside
them (float64) raises on the card, where the plain version on the CPU
takes any float type.

Widths.  A width runs at :func:`padded_width` (up to 128 the next of
:data:`WIDTHS`, past it the next multiple of 32) with zero columns added,
which change neither the output nor the state; past 128 the padded width is
cut into tiles of :data:`WIDTHS` (:func:`tile_width`: V into 128, 64 or 32
columns, K into slices of 64 or 32): the state pass runs a key slice a
block, the output pass a value slice a block and walks the key slices.
The kernel's tensor maps zero-fill the columns past a row, so r, k, v and
logw are copied padded only where a row's bytes are not a multiple of 16;
u and state0 are laid out padded (a copy of each, small beside the rows)
and the final state comes back sliced.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel

# (r, k, v, logw, u, state0, out, state, scratch, b, s, h, K, V, dtype,
# wdtype, passes, stream)
WKV = Kernel("rwkv6_wkv.cu", "rwkv6_wkv_launch",
             [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p])

HEAD_SIZE = 64      # rwkv6's K = V
WIDTHS = (32, 64, 128)   # the passes' tiles of K and V
# the kernel's type codes for r, k, v and out (logw: the same, or 0)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
CHUNK = 32          # the kernel's tokens per chunk
STATE_PASS, OUTPUT_PASS, BOTH_PASSES = 1, 2, 3


def launch_key(b: int, s: int, h: int, kk: int = HEAD_SIZE,
               vv: int = HEAD_SIZE, dtype=torch.float32) -> tuple:
    """What ``WKV.by_key`` counts a launch under: its (B, S, H), its widths
    K and V and the name of the type of r, k and v it launched in (a
    string, so a key goes into JSON as it is)."""
    return (b, s, h, kk, vv, str(dtype).removeprefix("torch."))


def padded_width(w: int) -> int:
    """The width a K or V of ``w`` runs at: up to 128 the least of
    :data:`WIDTHS` at or above it, past 128 the next multiple of 32."""
    if w < 1:
        raise ValueError(f"width {w}")
    for built in WIDTHS:
        if w <= built:
            return built
    return -(-w // 32) * 32


def tile_width(wp: int, key: bool = False) -> int:
    """The tile the passes cut a padded width into: itself up to 128, past
    it the largest of :data:`WIDTHS` that divides it, and for K (``key``)
    at most 64 (an output pass that walks key slices of 128 spills)."""
    if padded_width(wp) != wp:
        raise ValueError(f"{wp} is not a padded width")
    if wp <= WIDTHS[-1]:
        return wp
    return max(t for t in WIDTHS if wp % t == 0 and not (key and t > 64))


def scratch_shape(b: int, s: int, h: int, kk: int = HEAD_SIZE,
                  vv: int = HEAD_SIZE) -> tuple:
    """The chunk-start states the state pass writes and the output pass
    reads: (B, H, ceil(S / 32), padded K, padded V) float32."""
    return (b, h, -(-s // CHUNK), padded_width(kk), padded_width(vv))


def wkv(r, k, v, logw, u, state0):
    """The CUDA kernel: r, k, logw (B, S, H, K), v (B, S, H, V), u (H, K)
    and state0 (B, H, K, V), contiguous on one card, any K and V -> (out
    (B, S, H, V) in r's type, final state (B, H, K, V) float32).  r, k, v
    and logw must each be of a type of :data:`DTYPES` (float64 raises).  r, k and v of one type launch that
    type's kernel, with logw in that type or in float32; r, k and v of
    mixed types are widened to float32 before the launch, and so is a logw
    of a third type of :data:`DTYPES` (exact: the kernel widens them as it
    reads them); the output still comes back in r's type, rounded once.
    u and state0 may be any float type: they are taken to float32.  Any S: the kernel masks
    its ragged last chunk.  Both passes run in one launch of the entry
    point, counted once on ``WKV`` under :func:`launch_key`; the
    chunk-start states go through a scratch of :func:`scratch_shape`,
    freed on return."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (r, k, v, logw, u, state0)):
        raise RuntimeError("the WKV kernel has no backward: a tensor that "
                           "requires grad goes through ops.Rwkv6WkvFn")
    args = check_args(r, k, v, logw, u, state0)
    kk, vv = r.shape[-1], v.shape[-1]
    if v.numel() == 0:
        return torch.empty_like(v), args[5][:, :, :kk, :vv].clone()
    out, state, _ = run_passes(*args)
    if out.shape[-1] != vv:
        out = out[..., :vv].contiguous()
    if state.shape[-2:] != (kk, vv):
        state = state[:, :, :kk, :vv].contiguous()
    return out.to(r.dtype), state


def run_passes(r, k, v, logw, u, state0, *, passes: int = BOTH_PASSES,
               buffers=None):
    """Launch the state pass, the output pass or both (``passes`` 1, 2 or
    3) on checked arguments (:func:`check_args`: out comes back at v's
    width in memory, the state and the scratch at the padded widths);
    ``buffers`` (out, state, scratch) from an earlier call are reused, so
    the output pass alone can be run again on the scratch a state pass
    wrote.  Returns (out, state, scratch)."""
    b, s, h, kk = r.shape
    vv = v.shape[-1]
    if buffers is None:
        buffers = (torch.empty_like(v), torch.empty_like(state0),
                   torch.empty(scratch_shape(b, s, h, kk, vv),
                               dtype=torch.float32, device=r.device))
    out, state, scratch = buffers
    with torch.cuda.device(r.device):
        WKV(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), state0.data_ptr(), out.data_ptr(),
            state.data_ptr(), scratch.data_ptr(), b, s, h, kk, vv,
            DTYPES[r.dtype], DTYPES[logw.dtype], passes,
            torch.cuda.current_stream(r.device).cuda_stream,
            key=launch_key(b, s, h, kk, vv, r.dtype))
    return out, state, scratch


def _domain(name, x) -> None:
    if x.dtype not in DTYPES:
        raise NotImplementedError(
            f"the CUDA WKV kernel takes {tuple(DTYPES)} (ROADMAP B item 3), "
            f"{name} is {x.dtype}")


def _row_bytes_ok(width: int, *xs) -> bool:
    """Whether rows of ``width`` elements of each tensor's type span a
    multiple of 16 bytes (TMA's stride)."""
    return all(width * x.element_size() % 16 == 0 for x in xs)


def check_args(r, k, v, logw, u, state0):
    """The arguments the kernel takes: r, k, v and logw each of a type of
    :data:`DTYPES` (``NotImplementedError`` otherwise, float64 too); r, k,
    v in one type (all widened to float32 where they differ), logw in that
    type or float32 (widened otherwise); r, k and logw copied with zero
    columns to the padded K where a row's bytes are not a multiple of 16,
    v likewise to the padded V; u and state0 in float32 at the padded
    widths (:func:`padded_width`)."""
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, K), got shape {tuple(r.shape)}")
    b, s, h, kk = r.shape
    vv = v.shape[-1] if v.dim() == 4 else -1
    if kk < 1 or vv < 1:
        raise ValueError(f"K {kk} and V {vv} must be >= 1")
    for name, x in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        _domain(name, x)
    for name, x in (("u", u), ("state0", state0)):
        if not x.is_floating_point():
            raise ValueError(f"{name} must be a float tensor, got {x.dtype}")
    if not r.dtype == k.dtype == v.dtype:
        r, k, v = r.float(), k.float(), v.float()
    if logw.dtype not in (r.dtype, torch.float32):
        logw = logw.float()
    want = {"r": (b, s, h, kk), "k": (b, s, h, kk), "v": (b, s, h, vv),
            "logw": (b, s, h, kk), "u": (h, kk), "state0": (b, h, kk, vv)}
    args = {"r": r, "k": k, "v": v, "logw": logw, "u": u.float(),
            "state0": state0.float()}
    for name, x in args.items():
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, want "
                             f"{want[name]}")
    for name, x in args.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in args.items():
        if x.device.type != "cuda" or x.device != r.device:
            raise RuntimeError(f"wkv launches a CUDA kernel on one card; "
                               f"{name} is on {x.device}")
    kt, vt = padded_width(kk), padded_width(vv)
    if not _row_bytes_ok(kk, args["r"], args["logw"]):
        for name in ("r", "k", "logw"):
            args[name] = F.pad(args[name], (0, kt - kk))
    if not _row_bytes_ok(vv, args["v"]):
        args["v"] = F.pad(args["v"], (0, vt - vv))
    if kt != kk:
        args["u"] = F.pad(args["u"], (0, kt - kk))
    if (kt, vt) != (kk, vv):
        args["state0"] = F.pad(args["state0"], (0, vt - vv, 0, kt - kk))
    for name, x in args.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    return tuple(args.values())


def rwkv6_wkv(r, k, v, logw, u, state0):
    """r, k, logw (B, S, H, K), v (B, S, H, V), u (H, K), state0
    (B, H, K, V) -> (out in r's type, final state in float32).  The
    reference's ``chunk`` TPU tile has no counterpart: the kernel's own
    chunk is 32 tokens, and the function it computes is exact whatever the
    chunk."""
    if r.device.type == "cpu":
        return ref.rwkv6_wkv_chunked_ref(r, k, v, logw, u, state0)
    return wkv(r, k, v, logw, u, state0)
