#!/usr/bin/env python3
"""The flash kernel beside another checkout's on one GPU.

Run from the repository root, after unpacking the other checkout's kernel
sources (for the parent commit: ``mkdir -p build/parent && git archive
HEAD~1 src/repro_torch/kernels/csrc | tar -x -C build/parent``):

    python3 src/repro_torch/tools/flash_vs_parent.py --parent build/parent

It builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it ships
(``_build``) and the other checkout's copy (one ``nvcc`` into
``build/``, started first), and calls both libraries' entry points
through ctypes on the same seeded inputs:

- bf16 and f32 at every head dim both build (16, 32, 64, 80, 128, 256),
  causal with GQA, not causal, and windowed with a softcap, with lse: the
  two outputs and lse must be equal bit for bit (``[parent-ab]`` counts
  the cases that are and lists the ones that are not);
- ``ROWS`` (f16 at qwen3-14b's and zamba2-2.7b's heads, hd 96 bf16 at
  phi-3-mini's), timed in turns, other, shipped, shipped, other (medians of
  CUDA event timings, ``chip_smoke.time_ms``), beside
  ``scaled_dot_product_attention``.  The shipped side is ``attend``; a head
  dim the other library lacks (it returns cudaErrorInvalidValue) runs there
  zero-padded to the next of ``OTHER_HEAD_DIMS`` and sliced back, as
  ``attend`` did before that head dim was built.

Exits 1 if a bf16 or f32 case differs, and 2 without a card.
"""
import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SOURCE = Path("src/repro_torch/kernels/csrc/flash_attention.cu")
CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the head dims built before hd 96 was
OTHER_HEAD_DIMS = (16, 32, 64, 80, 128, 256)
# (label, B, S, H, Kh, hd, type), causal
ROWS = (("qwen3_heads_f16", 2, 4608, 40, 8, 128, torch.float16),
        ("zamba2_heads_f16", 2, 1024, 32, 32, 80, torch.float16),
        ("phi3_heads_hd96", 2, 4608, 32, 32, 96, torch.bfloat16))
INVALID_VALUE = 1   # cudaErrorInvalidValue


def call(fn, q, k, v, hd_true, causal=True, window=0, cap=0.0, lse=False):
    """(out, lse or None) of one library's flash_attention_launch, or None
    if it takes no such head dim."""
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    ls = torch.empty((b, h, s), device=q.device) if lse else None
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if ls is None else ls.data_ptr(), CODES[q.dtype], b, s,
             k.shape[1], h, k.shape[2], hd, int(causal), window,
             hd_true ** -0.5, cap, torch.cuda.current_stream().cuda_stream)
    if err == INVALID_VALUE:
        return None
    if err:
        raise RuntimeError(f"flash_attention_launch: error {err}")
    return out, ls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="root of the other "
                    "checkout (its src/repro_torch/kernels/csrc)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_vs_parent: no CUDA device", file=sys.stderr)
        return 2
    print("[card]", cs.card_identity(), flush=True)
    other_so = ROOT / "build" / "parent_flash.so"
    proc = subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                             str(other_so), str(Path(args.parent) / SOURCE)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    _build.build(("flash_attention.cu",))
    if proc.wait():
        raise RuntimeError(f"nvcc failed:\n{proc.stdout.read()[-3000:]}")
    libs = {}
    for name, path in (("parent", other_so),
                       ("change", _build.target("flash_attention.cu"))):
        fn = ctypes.CDLL(str(path)).flash_attention_launch
        fn.argtypes, fn.restype = fa.FLASH.argtypes, ctypes.c_int
        libs[name] = fn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    same, differ = 0, []
    with torch.no_grad():
        for dt in (torch.bfloat16, torch.float32):
            for hd in OTHER_HEAD_DIMS:
                for b, s, h, kh, causal, window, cap in (
                        (2, 1000, 8, 4, True, 0, 0.0),
                        (1, 777, 4, 4, False, 0, 0.0),
                        (1, 1100, 8, 2, True, 300, 50.0)):
                    q, k, v = ((torch.randn((b, s, n, hd), generator=gen,
                                            device=dev) * sc).to(dt)
                               for n, sc in ((h, cs.FLASH_Q_SCALE), (kh, 1.0),
                                             (kh, 1.0)))
                    got = [call(libs[n], q, k, v, hd, causal, window, cap,
                                lse=True) for n in ("parent", "change")]
                    torch.cuda.synchronize()
                    if torch.equal(got[0][0], got[1][0]) and \
                            torch.equal(got[0][1], got[1][1]):
                        same += 1
                    else:
                        differ.append((str(dt), hd, causal, window, cap))
        print(f"[parent-ab] bf16 and f32 out and lse bit for bit the other "
              f"library's: {same} cases; differ: {differ}", flush=True)

        for label, b, s, h, kh, hd, dt in ROWS:
            q, k, v = ((torch.randn((b, s, n, hd), generator=gen,
                                    device=dev) * sc).to(dt)
                       for n, sc in ((h, cs.FLASH_Q_SCALE), (kh, 1.0),
                                     (kh, 1.0)))

            def other(q=q, k=k, v=v, hd=hd):
                got = call(libs["parent"], q, k, v, hd)
                if got is not None:
                    return got[0]
                to = min(d for d in OTHER_HEAD_DIMS if d > hd)
                qp, kp, vp = (F.pad(x, (0, to - hd)).contiguous()
                              for x in (q, k, v))
                return call(libs["parent"], qp, kp, vp, hd)[0][
                    ..., :hd].contiguous()

            def shipped(q=q, k=k, v=v):
                return fa.attend(q, k, v)

            times = {"other": [], "shipped": []}
            for n in ("other", "shipped", "shipped", "other"):
                times[n].append(cs.time_ms(other if n == "other"
                                           else shipped))
            sdpa = cs.time_ms(lambda q=q, k=k, v=v: (
                F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True)))
            print(f"[parent-ab] {label}: other {times['other']} ms, shipped "
                  f"{times['shipped']} ms, SDPA {sdpa:.4f} ms", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
