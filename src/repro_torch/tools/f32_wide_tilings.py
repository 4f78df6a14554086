#!/usr/bin/env python3
"""The tilings tried for the f32 flash body past head dim 256
(``flash_3xtf32_wide``), built, checked and timed on one GPU.

Run from the repository root:

    python3 src/repro_torch/tools/f32_wide_tilings.py

Each variant in ``VARIANTS`` is a copy of
``src/repro_torch/kernels/csrc/flash_attention.cu`` under
``build/f32wide/`` with ``Tf32WideTile``'s keys a tile (BK), its blocks an
SM (kMinBlocks, the register budget ptxas is given), its output columns a
block (DV) and the unroll of the body's 8-deep depth steps replaced; one
``nvcc`` a variant, all started together.  For each: ptxas's registers and
spills of both ``flash_3xtf32_wide`` instantiations (``[tiling-build]``),
then its output at B 2, S 1024, H 8 over Kh 2, hd 512, causal, f32 (q at
``chip_smoke.FLASH_Q_SCALE``) held against the function computed in
float64 on the card at ``chip_smoke.TOL`` and timed (``chip_smoke.time_ms``,
every variant in turn, then in reverse order; ``[tiling]``).  Exits
non-zero if a variant fails its check, and 2 without a card.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"
OUT = ROOT / "build" / "f32wide"
# name: (BK, kMinBlocks, DV, unroll of the depth steps; "" unrolls all)
VARIANTS = {
    "bk32_b2_dv192_u2": (32, 2, 192, "2"),    # as shipped
    "bk32_b2_dv192_u4": (32, 2, 192, "4"),
    "bk16_b2_dv256_u8": (16, 2, 256, ""),
    "bk16_b2_dv256_u4": (16, 2, 256, "4"),
    "bk16_b2_dv256_u2": (16, 2, 256, "2"),
    "bk16_b2_dv192_u4": (16, 2, 192, "4"),
    "bk16_b2_dv128_u4": (16, 2, 128, "4"),
    "bk32_b2_dv128_u4": (32, 2, 128, "4"),
    "bk8_b2_dv256_u4": (8, 2, 256, "4"),
    "bk8_b3_dv256_u4": (8, 3, 256, "4"),
    "bk16_b3_dv128_u4": (16, 3, 128, "4"),
}
SHAPE = (2, 1024, 8, 2, 512)   # B, S, H, Kh, hd


def variant_source(bk: int, blocks: int, dv: int, unroll: str) -> str:
    src = SOURCE.read_text()
    a = src.index("struct Tf32WideTile {")
    b = src.index("};", a)
    tile = re.sub(r"BK = \d+;", f"BK = {bk};", src[a:b])
    tile = re.sub(r"DV = \d+;", f"DV = {dv};", tile)
    tile = re.sub(r"kMinBlocks = \d+;", f"kMinBlocks = {blocks};", tile)
    src = src[:a] + tile + src[b:]
    body = src.index("flash_3xtf32_wide(Params p)")
    steps = re.compile(r"#pragma unroll \d*\n(\s*)for \(int k8")
    m = steps.search(src, body)
    return (src[:m.start()] + f"#pragma unroll {unroll}\n{m.group(1)}"
            f"for (int k8" + src[m.end():])


def build(name: str):
    from repro_torch.kernels import _build

    cu = OUT / f"{name}.cu"
    cu.write_text(variant_source(*VARIANTS[name]))
    lib = OUT / f"{name}.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(cu)], capture_output=True, text=True)
    return name, proc.returncode, proc.stdout + proc.stderr


def main() -> int:
    if not torch.cuda.is_available():
        print("f32_wide_tilings: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import ref

    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(build, VARIANTS))
    fns = {}
    for name, rc, text in built:
        if rc:
            print(f"[tiling-build] {name}: nvcc exited {rc}\n{text}")
            return 1
        for kernel, arg, used, stack, spill in cs.ptxas_report(text):
            if kernel == cs.F32_WIDE_FLASH:
                print(f"[tiling-build] {name} cap {arg}: {used}; stack "
                      f"{stack} bytes, spill stores {spill} bytes")
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    b, s, h, kh, hd = SHAPE
    q = torch.randn((b, s, h, hd), generator=gen, device=dev) \
        * cs.FLASH_Q_SCALE
    k, v = (torch.randn((b, s, kh, hd), generator=gen, device=dev)
            for _ in range(2))
    truth = ref.flash_attention_ref(q.double(), k.double(),
                                    v.double()).float()
    outs = {name: torch.empty_like(q) for name in fns}

    def run(name):
        err = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        outs[name].data_ptr(), None, 0, b, s, s, h, kh, hd,
                        1, 0, hd ** -0.5, 0.0,
                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")

    failed = []
    for name in fns:
        run(name)
        again = outs[name].clone()
        run(name)
        torch.cuda.synchronize()
        err = (outs[name] - truth).abs().max().item()
        ok = torch.equal(again, outs[name]) and torch.allclose(
            outs[name], truth, **cs.TOL)
        if not ok:
            failed.append(name)
        print(f"[tiling] {name}: max_abs_err {err:.3e} against the f64 "
              f"function, two runs bit-identical and within TOL: {ok}")
    times = {name: [] for name in fns}
    for order in (list(fns), list(reversed(fns))):
        for name in order:
            times[name].append(cs.time_ms(lambda n=name: run(n)))
    for name, ts in times.items():
        print(f"[tiling] {name}: {ts[0]:.4f} / {ts[1]:.4f} ms")
    print(cs.card_identity())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
