#!/usr/bin/env python3
"""A/B timing of a flash body's design choices on one GPU: the bf16 hd
64/80/96 body, with ``--narrow`` the same body at hd 16 and 32, or with
``--f32`` the f32 body (3xTF32).

Run from the repository root:

    python3 src/repro_torch/tools/ab_flash.py [--narrow | --f32] [--parent DIR]

It builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it ships
and once per variant in ``VARIANTS`` (a copy of the source under
``build/ab/`` with some of the text of ``flash_wgmma_ws`` replaced), and,
with ``--parent``, the flash source of another checkout of the repository
(an earlier design).  Every build is one ``nvcc`` into ``build/ab/``, all
started together.  Each library's ``flash_attention_launch`` is called
through ctypes on the same seeded bf16 inputs at the shapes the main path
gives the body (``SHAPES``): granite-moe-3b-a800m's train shape (with lse),
zamba2-2.7b's shared block and whisper-tiny's encoder, and phi-3-mini's
heads at hd 96 (a library that does not take hd 96, as the parent of the
hd 96 body, is left out of that shape).

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

With ``--narrow`` the substitutions are ``VARIANTS_NARROW`` and ``PROBES``
(the tilings of hd 16 and 32 and part of the exponentials on the FMA
pipe) and the shapes ``SHAPES_NARROW`` (B 4, S 1024, H 8 over Kh 2, and
B 2, S 4608, H 32 over Kh 8, causal, at hd 16 and 32); the rest is as
above, and the ``[ab-build]`` lines give the hd 16 and 32 kernels.

With ``--f32`` the substitutions are ``VARIANTS_F32`` and ``PROBES_F32``
within ``flash_3xtf32`` (and its ``Tf32Tile``), the inputs are float32 at
``SHAPES_F32`` (zamba2-2.7b's f32 row, granite-moe's and qwen3-14b's heads
at S 1024, gemma2-9b's local layer), and each library's output is held
against the function computed in float64 on the card at
``chip_smoke.TOL``; the f32 plain version's own distance from it is
printed beside (an f32 sum over hd products with q at 4x unit scale is
itself some 1e-5 off at hd 256).
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

TURNS = "  static constexpr bool kTurns = HD >= 64;"
VARIANTS = {
    # the warpgroups issue whenever they are ready, with no turns
    "no_turns": [(TURNS, TURNS.replace("HD >= 64", "false"), False)],
    # heaviest query tiles first across every (batch, head) pair at once
    "all_heads_first": [("constexpr int kGroup = 8;",
                         "constexpr int kGroup = 1 << 20;", False)],
    # one (batch, head) pair after another, its heaviest tile first
    "pair_by_pair": [("constexpr int kGroup = 8;",
                      "constexpr int kGroup = 1;", False)],
    # the output rescaled on every tile, also where no row max moved
    "always_rescale": [("    if (__any_sync(0xffffffffu, corr[0] != 1.f || "
                        "corr[1] != 1.f)) {", "    {")],
    # 128-key tiles at hd 96 too (ptxas spills there at nine warps' 168
    # registers a thread)
    "hd96_bk128": [("  static constexpr int BK = HD < 64 ? 64 : "
                    "(HD == 96 ? 112 : 128);",
                    "  static constexpr int BK = HD < 64 ? 64 : 128;",
                    False)],
}
NO_SOFTMAX = [("  auto softmax_tile = [&](int k0) {\n",
               "  auto softmax_tile = [&](int k0) {\n    return;\n")]
NO_PRODUCTS = [
    ("        wgmma_scores<BK, T>(sc, sw128_desc(q_rows + kk * 32, 16),\n"
     "                            sw128_desc(ks + kk * 32, 16), kk > 0);",
     ";"),
    ("      wgmma_scores<BK, T>(sc, sw32_desc(q_rows2),\n"
     "                          sw32_desc(ks + Tile::kKWide), kWideBox);",
     ";"),
    ("        wgmma_scores<BK, T>(sc, sw64_desc(q_rows2 + kk * 32),\n"
     "                            sw64_desc(ks + Tile::kKWide + kk * 32),\n"
     "                            kWideBox || kk > 0);", ";"),
    ("        wgmma_rs_n64<T>(acc, pa[kk],\n"
     "                        sw128_desc(vs + kk * 16 * 128, Tile::kKWide));",
     ";"),
    ("wgmma_rs_n16<T>(acc2, pa[kk], sw32_desc(vs2 + kk * 16 * 32));", ";"),
    ("wgmma_rs_n32<T>(acc2, pa[kk], sw64_desc(vs2 + kk * 16 * 64));", ";")]
PROBES = {
    "probe_no_softmax": NO_SOFTMAX,
    "probe_no_products": NO_PRODUCTS,
    "probe_loads_only": NO_SOFTMAX + NO_PRODUCTS,
    # every exponential replaced by its argument (the SFU's share)
    "probe_no_exp": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : '
                      '"f"(x));', "y = x;", False)],
}
# the hd 16 and 32 tiling's lines in WsTile, which the narrow variants
# rewrite (outside the body)
BK_NARROW = "  static constexpr int BK = HD < 64 ? 64 : (HD == 96 ? 112 : 128);"
BLOCKS_NARROW = "  static constexpr int kMinBlocks = HD < 64 ? 2 : 1;"
STAGES_NARROW = "      HD < 64 ? 4 : (kMaxSmem - kQBytes - 2048) / (2 * kKBytes);"


def narrow_tile(bk: int, blocks: int, stages=None) -> list:
    """Substitutions giving hd 16 and 32 tiles of ``bk`` keys, a launch
    bound of ``blocks`` blocks an SM and a ring of ``stages`` (None: as
    many as fit beside Q)."""
    ring = (f"      HD < 64 ? {stages} : " if stages else "      ") + \
        "(kMaxSmem - kQBytes - 2048) / (2 * kKBytes);"
    return [(BK_NARROW, BK_NARROW.replace("HD < 64 ? 64", f"HD < 64 ? {bk}"),
             False),
            (BLOCKS_NARROW, BLOCKS_NARROW.replace("? 2", f"? {blocks}"),
             False),
            (STAGES_NARROW, ring, False)]


# 2^x on the FMA pipe for x <= 0: Cody-Waite, 2^floor(x) times a cubic in
# the fraction, fitted to 2^f on [0, 1) at a relative error under 8.6e-5
# (P is rounded to bf16's 2^-9 or f16's 2^-12 after it); below -126 the
# power's exponent would leave the normals, so x is clamped there (2^-126
# rounds to 0 in P V as ex2.approx.ftz's subnormals do)
EXP2_FMA = """__device__ __forceinline__ float exp2_fma(float x) {
  x = fmaxf(x, -126.f);
  const float j = floorf(x);
  const float f = x - j;
  const float p = fmaf(fmaf(fmaf(0.07706641405820847f, f,
                                 0.22764569520950317f), f,
                            0.6951166391372681f), f, 1.f);
  return __int_as_float(__float_as_int(p) + ((int)j << 23));
}

"""
EX2_LINE = "      float pe = ex2_approx(fmaf(sc[4 * n + e], unit, -ml[e >> 1]));"


def exp2_share(every: int) -> list:
    """Substitutions that take the exponentials of one score block in
    ``every`` on the FMA pipe (:data:`EXP2_FMA`) and the rest on the
    SFU."""
    return [("__device__ __forceinline__ float ex2_approx(float x) {",
             EXP2_FMA + "__device__ __forceinline__ float ex2_approx(float "
             "x) {", False),
            (EX2_LINE,
             "      const float xe = fmaf(sc[4 * n + e], unit, -ml[e >> 1]);\n"
             f"      float pe = n % {every} == {every - 1} ? exp2_fma(xe) : "
             "ex2_approx(xe);", False)]


VARIANTS_NARROW = {
    # one block an SM over 128-key tiles, the ring of 4 stages kept
    "narrow_bk128_one_block": narrow_tile(128, 1, 4),
    # one block an SM over 128-key tiles, as many stages as fit (13 at hd
    # 32): the tile the wide rows' habit would give
    "narrow_bk128_fill": narrow_tile(128, 1),
    # 64-key tiles, two blocks an SM, a ring of 2 or 8 stages
    "narrow_stages_2": narrow_tile(64, 2, 2),
    "narrow_stages_8": narrow_tile(64, 2, 8),
    # the warpgroups take turns on the tensor cores, as at hd 64 to 96
    "narrow_turns": [(TURNS, TURNS.replace("HD >= 64", "true"), False)],
    # a quarter or an eighth of the exponentials on the FMA pipe
    "narrow_exp2_fma_quarter": exp2_share(4),
    "narrow_exp2_fma_eighth": exp2_share(8),
}
# (label, B, S, H, Kh, hd, causal, lse)
SHAPES_NARROW = (("hd16_bf16", 4, 1024, 8, 2, 16, True, False),
                 ("hd32_bf16", 4, 1024, 8, 2, 32, True, False),
                 ("hd32_bf16_s4608", 2, 4608, 32, 8, 32, True, False),
                 ("hd16_bf16_s4608", 2, 4608, 32, 8, 16, True, False))
# the f32 body: its tile (per head dim, see Tf32Tile), its launch bound,
# and how it splits and sums
# the f32 body's Tf32Tile lines that variants rewrite
BK_F32 = "  static constexpr int BK = HD <= 96 ? 32 : (HD <= 128 ? 16 : 8);"
UNROLL_F32 = ("  static constexpr int kUnroll = "
              "HD <= 128 ? HD / 8 / kSteps : 4;")


MIN_BLOCKS_F32 = "  static constexpr int kMinBlocks = HD <= 128 ? 2 : 3;"


def HD256_F32(threads):
    """The substitution that bounds the body's launch at hd 256 as one of
    ``threads`` threads and two blocks an SM."""
    return ("__launch_bounds__(Tf32Tile<HD>::kThreads,\n"
            "                                  Tf32Tile<HD>::kMinBlocks)",
            f"__launch_bounds__(HD <= 128 ? 128 : {threads},\n"
            f"                                  HD <= 128 ? "
            f"Tf32Tile<HD>::kMinBlocks : 2)", False)


VARIANTS_F32 = {
    # twice the keys a tile
    "bk_double": [(BK_F32, "  static constexpr int BK = HD <= 96 ? 64 : "
                   "(HD <= 128 ? 32 : 16);", False)],
    # each 8-deep step of Q K^T added to S on the CUDA cores
    "steps_1": [("  static constexpr int kSteps = HD <= 128 ? 2 : 1;",
                 "  static constexpr int kSteps = 1;", False)],
    # a launch bound of three blocks an SM up to hd 128 too (168 registers)
    "min_blocks_3": [(MIN_BLOCKS_F32, "  static constexpr int kMinBlocks = "
                      "3;", False)],
    # small rounded to TF32 by cvt.rna too (as big is)
    "small_rounded": [("  small = __float_as_uint(x - __uint_as_float(big));",
                       "  small = tf32_round(x - __uint_as_float(big));",
                       False)],
    # hd 256: two blocks an SM (255 registers, where ptxas spills), alone,
    # with Q K^T's depth loop 8 steps at a time and two steps a group, or
    # with a launch bound of 136, 144 or 160 threads, which caps a thread
    # at 240, 227 or 204 registers (the block has 128)
    "hd256_mb2": [HD256_F32(128)],
    "hd256_mb2_steps_2_unroll_8": [
        HD256_F32(128),
        (UNROLL_F32, UNROLL_F32.replace(": 4;", ": 8;"), False),
        ("  static constexpr int kSteps = HD <= 128 ? 2 : 1;",
         "  static constexpr int kSteps = 2;", False)],
    "hd256_cap_240": [HD256_F32(136)],
    "hd256_cap_227": [HD256_F32(144)],
    "hd256_cap_204": [HD256_F32(160)],
}
PROBES_F32 = {
    # the operands passed as they are, no split (big = x, small = 0)
    "probe_no_split": [("  big = tf32_round(x);\n"
                        "  small = __float_as_uint(x - __uint_as_float(big));",
                        "  big = __float_as_uint(x);\n  small = 0u;", False)],
    # one TF32 product where there are three
    "probe_one_product": [("  mma_tf32(c, a_small, b_big);\n"
                           "  mma_tf32(c, a_big, b_small);\n", "", False)],
}
BODY_F32 = "flash_3xtf32(Params"
# (label, B, S, H, Kh, hd, window, softcap), causal
SHAPES_F32 = (("zamba2_heads_f32", 2, 1024, 32, 32, 80, 0, 0.0),
              ("granite_heads_f32", 2, 1024, 24, 8, 64, 0, 0.0),
              ("qwen3_heads_f32", 2, 1024, 40, 8, 128, 0, 0.0),
              ("gemma2_local_f32", 2, 4608, 16, 8, 256, 4096, 50.0))
SHAPES = (("granite_train_lse", 1, 4096, 24, 8, 64, True, True),
          ("zamba2_heads", 2, 4608, 32, 32, 80, True, False),
          ("whisper_encoder", 2, 1536, 6, 6, 64, False, False),
          ("phi3_heads_hd96", 2, 4608, 32, 32, 96, True, False))
INVALID_VALUE = 1   # cudaErrorInvalidValue: a head dim a library lacks


def variant_source(text: str, subs, body: str = BODY) -> str:
    """``text`` with each (old, new[, within the body]) substitution made
    once, within ``body`` (``flash_wgmma_ws``) unless the third item is
    False; raises if one does not apply."""
    for sub in subs:
        old, new = sub[:2]
        at = text.index(body) if (len(sub) < 3 or sub[2]) else 0
        if old not in text[at:]:
            raise ValueError(f"substitution does not apply: {old[:60]!r}")
        text = text[:at] + text[at:].replace(old, new, 1)
    return text


def build(parent, f32=False, narrow=False) -> dict:
    """{name: ctypes entry point} for the shipped source, every variant and
    probe, and the parent's source (one nvcc each, all at once); prints each
    one's ptxas report of the hd 64/80/96 body (with ``narrow``, of its hd
    16 and 32 kernels, from ``VARIANTS_NARROW``; with ``f32``, of the f32
    body, from ``VARIANTS_F32`` and ``PROBES_F32``)."""
    out = ROOT / "build" / "ab"
    out.mkdir(parents=True, exist_ok=True)
    shipped = (ROOT / SOURCE).read_text()
    sources = {"shipped": shipped}
    subs = ({**VARIANTS_F32, **PROBES_F32} if f32 else
            {**(VARIANTS_NARROW if narrow else VARIANTS), **PROBES})
    sources.update({n: variant_source(shipped, s,
                                      BODY_F32 if f32 else BODY)
                    for n, s in subs.items()})
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
            if narrow and arg and arg.split(",")[0] not in ("16", "32"):
                continue
            if kernel.startswith(cs.F32_FLASH if f32 else "flash_wgmma_ws"):
                print(f"[ab-build] {name} {kernel}<{arg}>: {used}; "
                      f"stack {stack} bytes, spill stores {spill} bytes",
                      flush=True)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="root of another checkout whose flash "
                    "source is timed beside the shipped one")
    ap.add_argument("--f32", action="store_true", help="the f32 body's "
                    "variants at SHAPES_F32")
    ap.add_argument("--narrow", action="store_true", help="the hd 16 and "
                    "32 variants at SHAPES_NARROW")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_flash: no CUDA device", file=sys.stderr)
        return 2
    print(f"[ab] card {cs.card_identity()}", flush=True)
    libs = build(args.parent, args.f32, args.narrow)
    if args.f32:
        return main_f32(libs)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    failed = []
    with torch.no_grad():
        for label, b, s, h, kh, hd, causal, want_lse in (
                SHAPES_NARROW if args.narrow else SHAPES):
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
                if err == INVALID_VALUE:
                    return None
                if err:
                    raise RuntimeError(f"flash_attention_launch: {err}")
                return out

            plain = ref.flash_attention_ref(q, k, v, causal=causal)
            here = {n: fn for n, fn in libs.items() if run(fn) is not None}
            checks = {}
            for name, fn in here.items():
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
            names = list(here)
            times = {n: [] for n in names}
            for order in (names, names[::-1]):
                for n in order:
                    times[n].append(cs.time_ms(lambda n=n: run(here[n])))
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


def exact_attention(q, k, v, *, window, softcap):
    """(B, S, H, hd) causal attention of f32 q, k, v computed in float64."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    kd = k.double().repeat_interleave(g, dim=2)
    vd = v.double().repeat_interleave(g, dim=2)
    sc = torch.einsum("bshd,bthd->bhst", q.double(), kd) * hd ** -0.5
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    ok = j <= i
    if window:
        ok = ok & ((i - j) < window)
    p = sc.masked_fill(~ok, float("-inf")).softmax(-1)
    return torch.einsum("bhst,bthd->bshd", p, vd)


def main_f32(libs) -> int:
    """The f32 body's variants at SHAPES_F32: each held at chip_smoke.TOL
    against the float64 function and timed in turns beside SDPA (where it
    computes the layer) and the f32 plain version's distance."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    failed = []
    with torch.no_grad():
        for label, b, s, h, kh, hd, window, cap in SHAPES_F32:
            q, k, v = ((torch.randn((b, s, n, hd), generator=gen, device=dev)
                        * sc) for n, sc in ((h, cs.FLASH_Q_SCALE), (kh, 1.0),
                                            (kh, 1.0)))
            out = torch.empty_like(q)

            def run(fn, q=q, k=k, v=v, out=out, b=b, s=s, h=h, kh=kh, hd=hd,
                    window=window, cap=cap):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), None, 0, b, s, s, h, kh, hd, 1,
                         window, hd ** -0.5, cap,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"flash_attention_launch: {err}")
                return out

            truth = exact_attention(q, k, v, window=window, softcap=cap)
            plain = ref.flash_attention_ref(q, k, v, window=window,
                                            softcap=cap)
            plain_err = (plain.double() - truth).abs().max().item()
            del plain
            checks = {}
            for name, fn in libs.items():
                first = run(fn).clone()
                again = run(fn)
                torch.cuda.synchronize()
                err = (first.double() - truth).abs().max().item()
                ok = torch.equal(first, again) and torch.allclose(
                    first.double(), truth, **cs.TOL)
                checks[name] = (ok, err)
                if not ok and not name.startswith("probe"):
                    failed.append(f"{label} {name}")
            names = list(libs)
            times = {n: [] for n in names}
            for order in (names, names[::-1]):
                for n in order:
                    times[n].append(cs.time_ms(lambda n=n: run(libs[n])))
            for n in names:
                ok, err = checks[n]
                held = ("probe, not held" if n.startswith("probe")
                        else "held" if ok else "FAILED")
                print(f"[ab-f32] {label} {n}: {times[n][0]:.4f} "
                      f"{times[n][1]:.4f} ms; max |out - f64| {err:.3e} "
                      f"({held})", flush=True)
            line = (f"[ab-f32] {label}: the f32 plain version's max |out - "
                    f"f64| {plain_err:.3e}")
            if not window and not cap:
                sdpa = cs.time_ms(lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True))
                line += f"; scaled_dot_product_attention {sdpa:.4f} ms"
            print(line, flush=True)
            del q, k, v, out, truth
            torch.cuda.empty_cache()
    if failed:
        print(f"[ab-f32] failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
