#!/usr/bin/env python3
"""A/B timing of the bf16 hd 64/80 flash body's design choices on one GPU.

Run from the repository root:

    python3 src/repro_torch/tools/ab_flash.py [--parent DIR]

It builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it ships
and once per variant in ``VARIANTS`` (a copy of the source under
``build/ab/`` with some of the text of ``flash_wgmma_ws`` replaced), and,
with ``--parent``, the flash source of another checkout of the repository
(an earlier design).  Every build is one ``nvcc`` into ``build/ab/``, all
started together.  Each library's ``flash_attention_launch`` is called
through ctypes on the same seeded bf16 inputs at the shapes the main path
gives the body (``SHAPES``): granite-moe-3b-a800m's train shape (with lse),
zamba2-2.7b's shared block and whisper-tiny's encoder.

Design variants are held against the plain PyTorch version at
``chip_smoke.FLASH_TOL`` / ``FLASH_REL`` and two of their runs must be
bit-identical; probe variants (``PROBES``) remove work to show what the
body spends its time on, compute something else and are not held.  Times
are medians of CUDA event timings (``chip_smoke.time_ms``), taken in turns
— every library, then every library in reverse order — beside
``scaled_dot_product_attention`` on the same inputs.  One ``[ab]`` line per
(shape, library) and one ``[ab-build]`` line per library (ptxas registers
and spills of ``flash_wgmma_ws``); exits non-zero if a design variant fails
its check, and 2 without a card.
"""
from __future__ import annotations

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
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.flash_attention import FLASH  # noqa: E402

SOURCE = Path("src/repro_torch/kernels/csrc/flash_attention.cu")
BODY = "flash_wgmma_ws(const"   # substitutions apply from here on

TURNS = [('    asm volatile("bar.sync %0, 256;\\n" ::"r"(1 + wg) : "memory");',
          ""),
         ('    asm volatile("bar.arrive %0, 256;\\n" ::"r"(2 - wg) : "memory");',
          "")]
VARIANTS = {
    # the warpgroups issue whenever they are ready, with no turns
    "no_turns": TURNS,
    # heaviest query tiles first across every (batch, head) pair at once
    "all_heads_first": [("constexpr int kGroup = 8;",
                         "constexpr int kGroup = 1 << 20;", False)],
    # one (batch, head) pair after another, its heaviest tile first
    "pair_by_pair": [("constexpr int kGroup = 8;",
                      "constexpr int kGroup = 1;", False)],
    # the output rescaled on every tile, also where no row max moved
    "always_rescale": [("    if (__any_sync(0xffffffffu, corr[0] != 1.f || "
                        "corr[1] != 1.f)) {", "    {")],
}
NO_SOFTMAX = [("  auto softmax_tile = [&](int k0) {\n",
               "  auto softmax_tile = [&](int k0) {\n    return;\n")]
NO_PRODUCTS = [
    ("      wgmma_ss_n128(sc, sw128_desc(q_rows + kk * 32, 16),\n"
     "                    sw128_desc(ks + kk * 32, 16), kk > 0);", ";"),
    ("wgmma_ss_n128(sc, sw32_desc(q_rows2), sw32_desc(ks + Tile::kKWide), 1);",
     ";"),
    ("wgmma_rs_n64(acc, pa[kk], sw128_desc(vs + kk * 16 * 128, "
     "Tile::kKWide));", ";"),
    ("wgmma_rs_n16(acc2, pa[kk], sw32_desc(vs + Tile::kKWide + kk * 16 * "
     "32));", ";")]
PROBES = {
    "probe_no_softmax": NO_SOFTMAX,
    "probe_no_products": NO_PRODUCTS,
    "probe_loads_only": NO_SOFTMAX + NO_PRODUCTS,
    # every exponential replaced by its argument (the SFU's share)
    "probe_no_exp": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : '
                      '"f"(x));', "y = x;", False)],
}
# (label, B, S, H, Kh, hd, causal, lse)
SHAPES = (("granite_train_lse", 1, 4096, 24, 8, 64, True, True),
          ("zamba2_heads", 2, 4608, 32, 32, 80, True, False),
          ("whisper_encoder", 2, 1536, 6, 6, 64, False, False))


def variant_source(text: str, subs) -> str:
    """``text`` with each (old, new[, within the body]) substitution made
    once, within ``flash_wgmma_ws`` unless the third item is False; raises
    if one does not apply."""
    for sub in subs:
        old, new = sub[:2]
        at = text.index(BODY) if (len(sub) < 3 or sub[2]) else 0
        if old not in text[at:]:
            raise ValueError(f"substitution does not apply: {old[:60]!r}")
        text = text[:at] + text[at:].replace(old, new, 1)
    return text


def build(parent) -> dict:
    """{name: ctypes entry point} for the shipped source, every variant and
    probe, and the parent's source (one nvcc each, all at once); prints each
    one's ptxas report of the hd 64/80 body."""
    out = ROOT / "build" / "ab"
    out.mkdir(parents=True, exist_ok=True)
    shipped = (ROOT / SOURCE).read_text()
    sources = {"shipped": shipped}
    sources.update({n: variant_source(shipped, s)
                    for n, s in {**VARIANTS, **PROBES}.items()})
    if parent is not None:
        sources["parent"] = (Path(parent) / SOURCE).read_text()
    procs = {}
    for name, text in sources.items():
        cu = out / f"flash_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out / f"flash_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(out / f"flash_{name}.so")).flash_attention_launch
        fn.argtypes, fn.restype = FLASH.argtypes, ctypes.c_int
        libs[name] = fn
        for kernel, arg, used, stack, spill in cs.ptxas_report(log):
            if kernel == "flash_wgmma_ws":
                print(f"[ab-build] {name} flash_wgmma_ws<{arg}>: {used}; "
                      f"stack {stack} bytes, spill stores {spill} bytes",
                      flush=True)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="root of another checkout whose flash "
                    "source is timed beside the shipped one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_flash: no CUDA device", file=sys.stderr)
        return 2
    print(f"[ab] card {cs.card_identity()}", flush=True)
    libs = build(args.parent)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    failed = []
    with torch.no_grad():
        for label, b, s, h, kh, hd, causal, want_lse in SHAPES:
            q, k, v = ((torch.randn((b, s, n, hd), generator=gen, device=dev)
                        * sc).to(torch.bfloat16)
                       for n, sc in ((h, cs.FLASH_Q_SCALE), (kh, 1.0),
                                     (kh, 1.0)))
            out = torch.empty_like(q)
            lse = (torch.empty((b, h, s), dtype=torch.float32, device=dev)
                   if want_lse else None)

            def run(fn, q=q, k=k, v=v, out=out, lse=lse, b=b, s=s, h=h,
                    kh=kh, hd=hd, causal=causal):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(),
                         None if lse is None else lse.data_ptr(), 1, b, s, s,
                         h, kh, hd, int(causal), 0, hd ** -0.5, 0.0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"flash_attention_launch: {err}")
                return out

            plain = ref.flash_attention_ref(q, k, v, causal=causal)
            checks = {}
            for name, fn in libs.items():
                first = run(fn).clone()
                again = run(fn)
                torch.cuda.synchronize()
                _, fro, _ = cs.errors(first, plain, cs.FLASH_TOL["rtol"])
                ok = torch.equal(first, again) and fro <= cs.FLASH_REL and \
                    torch.allclose(first.float(), plain.float(),
                                   **cs.FLASH_TOL)
                checks[name] = (ok, fro)
                if not ok and not name.startswith("probe"):
                    failed.append(f"{label} {name}")
            names = list(libs)
            times = {n: [] for n in names}
            for order in (names, names[::-1]):
                for n in order:
                    times[n].append(cs.time_ms(lambda n=n: run(libs[n])))
            sdpa = cs.time_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True))
            for n in names:
                ok, fro = checks[n]
                held = ("probe, not held" if n.startswith("probe")
                        else "held" if ok else "FAILED")
                print(f"[ab] {label} {n}: {times[n][0]:.4f} "
                      f"{times[n][1]:.4f} ms; relative Frobenius "
                      f"{fro:.3e} ({held})", flush=True)
            print(f"[ab] {label} scaled_dot_product_attention: {sdpa:.4f} ms",
                  flush=True)
            del q, k, v, out, lse, plain
            torch.cuda.empty_cache()
    if failed:
        print(f"[ab] failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
