#!/usr/bin/env python3
"""The flash kernel beside another checkout's on one GPU.

Run from the repository root, after unpacking the other checkout's kernel
sources (for the parent commit: ``mkdir -p build/parent && git archive
HEAD~1 src/repro_torch/kernels/csrc | tar -x -C build/parent``):

    python3 src/repro_torch/tools/flash_vs_parent.py --parent build/parent

It builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it ships
(``_build``) and the other checkout's copy (one ``nvcc`` into
``build/``, started first), compiles both to PTX (``build/ptx/``) and
compares every kernel that both build, apart from the 16-bit body at the
head dims in ``REBUILT``, instruction for instruction (``[parent-ptx]``;
the anonymous namespace's name, which carries digests of the file, and
the function's index in the module, which its branch labels carry, are
masked), and calls both libraries' entry points through ctypes on the
same seeded inputs:

- bf16 and f16 at every head dim (16, 32, 64, 80, 96, 128, 256), causal
  with GQA, not causal, and windowed with a softcap, with lse: the two
  outputs and lse must be equal bit for bit (``[parent-ab]`` counts the
  cases that are and lists the ones that are not), except at the head
  dims in ``REBUILT`` (16 and 32, whose body this checkout rebuilt: the
  narrow-row ``flash_wgmma_ws`` in place of ``flash_bf16``), where the
  shipped output must be within ``chip_smoke.FLASH_TOL`` and
  ``FLASH_REL`` of the plain version and its lse within
  ``chip_smoke.LSE_TOL``, two runs bit-identical (``[parent-narrow]``
  gives the largest distances, the other library's beside);
- f32 at the same cases: the f32 body may sum in another order than the
  other checkout's (3xTF32 tensor-core products against the CUDA cores'
  FMA chains), so neither is held to the other's bits.  The shipped
  output must be within ``chip_smoke.TOL`` and its lse within
  ``LSE_TOL[float32]`` of the plain version evaluated in f64 (the exact
  function, as ``chip_smoke.flash_row`` holds the f32 rows);
  ``[parent-f32]`` gives the largest distance of the shipped body, the
  other library and the f32 plain version from it, and the shipped body's
  from the other library's;
- ``ROWS`` (every f32 row of ``chip_smoke.py``, the 16-bit rows at hd 16
  and 32, ``chip_smoke.BF16_SMALL_ROWS``, and two other 16-bit rows as a
  control), timed in turns, other, shipped, shipped, other (medians of
  CUDA event timings, ``chip_smoke.time_ms``), beside
  ``scaled_dot_product_attention`` where one call computes the layer.  The
  shipped side is ``attend``; a head dim outside ``fa.HEAD_DIMS`` (the
  smoke configs' 8) runs zero-padded on both sides.

Exits 1 if a kernel's PTX differs, a bf16 or f16 case differs (at hd 16
and 32: is out of tolerance or differs between two runs) or an f32 case of
the shipped body is out of tolerance, and 2 without a card.
"""
import argparse
import ctypes
import re
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
from repro_torch.kernels import ref  # noqa: E402

SOURCE = Path("src/repro_torch/kernels/csrc/flash_attention.cu")
CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the 16-bit head dims whose body this checkout rebuilt: held to the plain
# version, not to the other library's bits
REBUILT = (16, 32)
# (label, B, S, H, Kh, hd, window, softcap, type), causal: chip_smoke's
# hd 16 and 32 bf16 rows (BF16_SMALL_ROWS) and f32 rows (zamba2's and the
# smoke configs' heads, F32_FLASH_ROWS), then f16 at qwen3-14b's heads and
# hd 96 bf16 at phi-3-mini's
ROWS = tuple((label, b, s, h, kh, hd, 0, 0.0, torch.bfloat16)
             for label, b, s, h, kh, hd in cs.BF16_SMALL_ROWS) + (
    ("zamba2_heads_f32", 2, 1024, 32, 32, 80, 0, 0.0, torch.float32),
    ("smoke_hd8_f32", 4, 8, 8, 2, 8, 0, 0.0, torch.float32),
    ("granite_heads_f32", 2, 1024, 24, 8, 64, 0, 0.0, torch.float32),
    ("qwen3_heads_f32", 2, 1024, 40, 8, 128, 0, 0.0, torch.float32),
    ("gemma2_local_f32", 2, 4608, 16, 8, 256, 4096, 50.0, torch.float32),
    ("qwen3_heads_f16", 2, 4608, 40, 8, 128, 0, 0.0, torch.float16),
    ("phi3_heads_hd96", 2, 4608, 32, 32, 96, 0, 0.0, torch.bfloat16))


PTX_FLAGS = ("-gencode", "arch=compute_90a,code=compute_90a", "-std=c++17",
             "-O3", "-ptx")
# the anonymous namespace's name in a mangled one: its length, then
# "_GLOBAL__N_" (or "_INTERNAL_"), digests and the file's name
ANON = re.compile(r"(\d+)(_GLOBAL__N_|_INTERNAL_)")
# a function's index in the module, in its branch labels and local depot:
# it moves when a kernel before it is added or removed
INDEX = re.compile(r"(\$L__BB|__local_depot)\d+")


def mask_anon(text: str) -> str:
    """``text`` with each anonymous namespace's name, as long as its
    mangled length says, replaced by "ANON", and the function's index in
    the module left out of its labels."""
    out, pos = [], 0
    for m in ANON.finditer(text):
        if m.start() >= pos:
            out += [text[pos:m.start()], "ANON"]
            pos = m.start(2) + int(m.group(1))
    return INDEX.sub(r"\1", "".join(out + [text[pos:]]))


def ptx_kernels(text: str) -> dict:
    """{(kernel, template arguments): its PTX, the anonymous namespace's
    name masked} for every kernel of a PTX module that
    ``chip_smoke.KERNEL_NAMES`` names."""
    out = {}
    # a kernel of the anonymous namespace is no .globl: split at .entry
    for block in re.split(r"\n(?=(?:\.visible\s+|\.weak\s+)?\.entry\s)",
                          text)[1:]:
        mangled = re.search(r"\.entry\s+([^\s(]+)", block).group(1)
        m = cs.KERNEL_NAMES.search(mangled)
        if m:
            name = m.group(1) + (cs.TYPE_SUFFIX[m.group(3)] if m.group(3)
                                 else "")
            out[(name, ",".join(re.findall(r"Li(\d+)E", m.group(2))))] = \
                mask_anon(block)
    return out


def compare_ptx(procs) -> list:
    """Prints ``[parent-ptx]``: the kernels both modules build, outside
    ``REBUILT``'s 16-bit body, and those whose PTX differs (returned)."""
    mods = {}
    for name, (proc, path) in procs.items():
        if proc.wait():
            raise RuntimeError(f"nvcc -ptx failed for {name}:\n"
                               f"{proc.stdout.read()[-3000:]}")
        mods[name] = ptx_kernels(path.read_text())
    rebuilt = {f"{hd}" for hd in REBUILT}
    common = sorted(k for k in mods["parent"].keys() & mods["change"].keys()
                    if not (k[0].startswith("flash_wgmma_ws_") and
                            k[1].split(",")[0] in rebuilt))
    differ = [k for k in common if mods["parent"][k] != mods["change"][k]]
    if not common:
        differ = ["no kernel found in the PTX"]
    only = sorted(mods["parent"].keys() ^ mods["change"].keys())
    print(f"[parent-ptx] {len(common) - len(differ)} of {len(common)} "
          f"kernels built by both (the 16-bit body at hd {REBUILT} left "
          f"out) have the other library's PTX; differ: {differ}; built by "
          f"one alone: {only}", flush=True)
    return differ


def call(fn, q, k, v, hd_true, causal=True, window=0, cap=0.0, lse=False):
    """(out, lse or None) of one library's flash_attention_launch at a
    built head dim."""
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    ls = torch.empty((b, h, s), device=q.device) if lse else None
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if ls is None else ls.data_ptr(), CODES[q.dtype], b, s,
             k.shape[1], h, k.shape[2], hd, int(causal), window,
             hd_true ** -0.5, cap, torch.cuda.current_stream().cuda_stream)
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
    ptx_dir = ROOT / "build" / "ptx"
    ptx_dir.mkdir(parents=True, exist_ok=True)
    ptx = {}
    for name, src in (("parent", Path(args.parent) / SOURCE),
                      ("change", ROOT / SOURCE)):
        path = ptx_dir / f"{name}.ptx"
        ptx[name] = (subprocess.Popen(
            [_build.nvcc(), *PTX_FLAGS, "-o", str(path), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            path)
    _build.build(("flash_attention.cu",))
    if proc.wait():
        raise RuntimeError(f"nvcc failed:\n{proc.stdout.read()[-3000:]}")
    ptx_differ = compare_ptx(ptx)
    libs = {}
    for name, path in (("parent", other_so),
                       ("change", _build.target("flash_attention.cu"))):
        fn = ctypes.CDLL(str(path)).flash_attention_launch
        fn.argtypes, fn.restype = fa.FLASH.argtypes, ctypes.c_int
        libs[name] = fn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    same, differ, f32_bad = 0, [], []
    narrow_err = {"out": 0.0, "relative Frobenius": 0.0, "lse": 0.0,
                  "other out": 0.0, "other lse": 0.0}
    f32_err = {"out": 0.0, "lse": 0.0, "other out": 0.0, "other lse": 0.0,
               "f32 plain out": 0.0, "f32 plain lse": 0.0,
               "out vs other": 0.0}
    lse_tol = cs.LSE_TOL[torch.float32]
    with torch.no_grad():
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            for hd in fa.HEAD_DIMS:
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
                    case = (str(dt), hd, causal, window, cap)
                    if dt != torch.float32 and hd in REBUILT:
                        again = call(libs["change"], q, k, v, hd, causal,
                                     window, cap, lse=True)
                        plain, plain_lse = ref.flash_attention_ref(
                            q, k, v, causal=causal, window=window,
                            softcap=cap, return_lse=True)
                        plain_lse = plain_lse.float().reshape(b, h, s)
                        torch.cuda.synchronize()
                        out_err, fro, _ = cs.errors(
                            got[1][0], plain, cs.FLASH_TOL["rtol"])
                        lse_err = (got[1][1] - plain_lse).abs().max().item()
                        for part, e in (
                                ("out", out_err), ("relative Frobenius", fro),
                                ("lse", lse_err),
                                ("other out", (got[0][0].float() - plain.float()
                                               ).abs().max().item()),
                                ("other lse", (got[0][1] - plain_lse
                                               ).abs().max().item())):
                            narrow_err[part] = max(narrow_err[part], e)
                        if torch.equal(got[1][0], again[0]) and \
                                torch.equal(got[1][1], again[1]) and \
                                fro <= cs.FLASH_REL and torch.allclose(
                                    got[1][0].float(), plain.float(),
                                    **cs.FLASH_TOL) and torch.allclose(
                                    got[1][1], plain_lse, **cs.LSE_TOL[dt]):
                            same += 1
                        else:
                            differ.append(case)
                        continue
                    if dt != torch.float32:
                        if torch.equal(got[0][0], got[1][0]) and \
                                torch.equal(got[0][1], got[1][1]):
                            same += 1
                        else:
                            differ.append(case)
                        continue
                    kw = {"causal": causal, "window": window,
                          "softcap": cap}
                    truth, truth_lse = ref.flash_attention_ref(
                        q.double(), k.double(), v.double(), return_lse=True,
                        **kw)
                    plain, plain_lse = ref.flash_attention_ref(
                        q, k, v, return_lse=True, **kw)
                    truth_lse = truth_lse.reshape(b, h, s)
                    plain_lse = plain_lse.reshape(b, h, s)
                    for part, x, y in (
                            ("out", got[1][0], truth),
                            ("lse", got[1][1], truth_lse),
                            ("other out", got[0][0], truth),
                            ("other lse", got[0][1], truth_lse),
                            ("f32 plain out", plain, truth),
                            ("f32 plain lse", plain_lse, truth_lse),
                            ("out vs other", got[1][0], got[0][0])):
                        f32_err[part] = max(f32_err[part], (
                            x.double() - y.double()).abs().max().item())
                    if not torch.allclose(got[1][0].double(), truth,
                                          **cs.TOL):
                        f32_bad.append(("out",) + case)
                    if not torch.allclose(got[1][1].double(), truth_lse,
                                          **lse_tol):
                        f32_bad.append(("lse",) + case)
        print(f"[parent-ab] bf16 and f16 out and lse bit for bit the other "
              f"library's (at hd {REBUILT}: within the flash tolerance and "
              f"lse tolerance of the plain version, two runs bit-identical): "
              f"{same} cases; differ: {differ}", flush=True)
        print(f"[parent-narrow] bf16 and f16 at hd {REBUILT}, largest "
              f"distances from the plain version: "
              f"{ {k: f'{e:.3e}' for k, e in narrow_err.items()} }",
              flush=True)
        print(f"[parent-f32] f32 out within {cs.TOL} and lse within "
              f"{lse_tol} of the plain version in f64 at "
              f"{3 * len(fa.HEAD_DIMS)} cases; largest distances from it "
              f"{ {k: f'{e:.3e}' for k, e in f32_err.items()} }; out of "
              f"tolerance: {f32_bad}", flush=True)

        for label, b, s, h, kh, hd, window, cap, dt in ROWS:
            q, k, v = ((torch.randn((b, s, n, hd), generator=gen,
                                    device=dev) * sc).to(dt)
                       for n, sc in ((h, cs.FLASH_Q_SCALE), (kh, 1.0),
                                     (kh, 1.0)))
            kw = {"window": window, "softcap": cap}

            def other(q=q, k=k, v=v, hd=hd, kw=kw):
                # padded and sliced inside the timed call, as attend does
                qp, kp, vp, _ = fa.pad_head_dim(q, k, v)
                out = call(libs["parent"], qp, kp, vp, hd, True,
                           kw["window"], kw["softcap"])[0]
                return out if qp is q else out[..., :hd].contiguous()

            def shipped(q=q, k=k, v=v, kw=kw):
                return fa.attend(q, k, v, **kw)

            times = {"other": [], "shipped": []}
            for n in ("other", "shipped", "shipped", "other"):
                times[n].append(cs.time_ms(other if n == "other"
                                           else shipped))
            line = (f"[parent-ab] {label}: other {times['other']} ms, "
                    f"shipped {times['shipped']} ms")
            if not window and not cap:
                sdpa = cs.time_ms(lambda q=q, k=k, v=v: (
                    F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), is_causal=True,
                        enable_gqa=True)))
                line += f", SDPA {sdpa:.4f} ms"
            print(line, flush=True)
            del q, k, v
    return 1 if ptx_differ or differ or f32_bad else 0


if __name__ == "__main__":
    sys.exit(main())
