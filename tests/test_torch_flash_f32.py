"""The CPU model of the flash kernel's f32 body (``flash_3xtf32``: 3xTF32
products on the tensor cores) against the JAX reference, on the CPU.

``ref.tf32_round`` models ``cvt.rna.tf32.f32`` on the f32 bits (held here
on ties, subnormals, the largest finite values, infinities and NaN, and
against a float64 rounding of random draws; on the card ``chip_smoke.py``
holds it bit for bit against the body's own rounding).
``ref.flash_attention_f32_tc_ref`` walks the body's tiles
(``ref.f32_tc_tiles(hd)``; key tiles from the window's start rounded
down) with each product taken as three TF32 products of the split
operands, and is
held against the interpret-mode Pallas kernel (out) and the residual of
the reference's ``_flash_vjp_fwd`` (lse) at rtol = atol = 1e-5, the f32
gate of ``chip_smoke.py``, at every built head dim.  The single-pass TF32
model (one product of the rounded operands) fails that gate on the same
inputs: the split is what keeps f32 accuracy.  q is drawn at
``FLASH_Q_SCALE`` (4x unit scale) as on the card, so each row's softmax is
peaked and the scores span several units.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig
from repro.kernels import flash_attention as jfa
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref

TOL = {"rtol": 1e-5, "atol": 1e-5}
Q_SCALE = 4.0
# (S, H, Kh, window, causal, softcap, the Pallas tile): causal with GQA at
# an S that is no multiple of the query tile; not causal, windowed,
# capped; causal, windowed and capped (gemma2's local layer) with a window
# whose first live key tile admits no key of some rows
CASES = [
    (100, 4, 2, 0, True, 0.0, 50),
    (96, 2, 1, 24, False, 30.0, 32),
    (160, 2, 2, 40, True, 50.0, 32),
]


def _qkv(seed, s, h, kh, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32) * scale
                 for shape, scale in (((1, s, h, hd), Q_SCALE),
                                      ((1, s, kh, hd), 1.0),
                                      ((1, s, kh, hd), 1.0)))


def _pallas(q, k, v, tile, **kw):
    return np.asarray(jfa.flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cq=tile, ck=tile,
        interpret=True, **kw))


def _bits(*patterns):
    return torch.tensor(np.array(patterns, dtype=np.uint32).view(
        np.int32)).view(torch.float32)


def _hex(x):
    return [hex(int(b) & 0xFFFFFFFF) for b in x.view(torch.int32)]


class TestTf32Round:
    def test_ties_round_away_from_zero(self):
        # 1 + 2^-11 lies halfway between 1 and 1 + 2^-10: to nearest even
        # would give 1, cvt.rna gives 1 + 2^-10; just under the tie rounds
        # down, just over rounds up; ties at an odd last bit round up too
        x = _bits(0x3F801000, 0xBF801000, 0x3F800FFF, 0x3F801001,
                  0x3F803000, 0xBF803000)
        assert _hex(tref.tf32_round(x)) == _hex(_bits(
            0x3F802000, 0xBF802000, 0x3F800000, 0x3F802000, 0x3F804000,
            0xBF804000))

    def test_subnormals_round_on_the_same_bits(self):
        # the smallest subnormals go to (signed) zero, a half step rounds
        # up, and the largest subnormal rounds into the smallest normal
        x = _bits(0x00000001, 0x80000FFF, 0x00001000, 0x00003000,
                  0x007FF000, 0x807FFFFF)
        assert _hex(tref.tf32_round(x)) == _hex(_bits(
            0x00000000, 0x80000000, 0x00002000, 0x00004000, 0x00800000,
            0x80800000))

    def test_specials_and_overflow(self):
        # the largest TF32 value stays, half a step past it becomes inf;
        # zeros, infinities and NaN pass
        x = _bits(0x7F7FE000, 0x7F7FEFFF, 0x7F7FF000, 0xFF7FFFFF,
                  0x00000000, 0x80000000, 0x7F800000, 0xFF800000)
        assert _hex(tref.tf32_round(x)) == _hex(_bits(
            0x7F7FE000, 0x7F7FE000, 0x7F800000, 0xFF800000, 0x00000000,
            0x80000000, 0x7F800000, 0xFF800000))
        nan = tref.tf32_round(torch.tensor([math.nan, -math.nan]))
        assert torch.isnan(nan).all()

    def test_matches_a_float64_rounding(self):
        # an independent model: the significand scaled to 11 bits, rounded
        # half away from zero in float64
        x = np.random.default_rng(0).standard_normal(100_000).astype(
            np.float32) * np.float32(1e3)
        mant, exp = np.frexp(x.astype(np.float64))
        want = np.sign(mant) * np.floor(np.abs(mant) * 2.0 ** 11 + 0.5)
        want = np.ldexp(want, exp - 11).astype(np.float32)
        got = tref.tf32_round(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))

    def test_truncate_cuts_toward_zero(self):
        x = _bits(0x3F801FFF, 0xBF801FFF, 0x00001FFF, 0x7F800000)
        assert _hex(tref.tf32_truncate(x)) == _hex(_bits(
            0x3F800000, 0xBF800000, 0x00000000, 0x7F800000))

    def test_split_keeps_x_to_two_to_the_minus_21(self):
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            100_000).astype(np.float32))
        big, small = tref.split_tf32(x)
        assert (big.view(torch.int32) & 0x1FFF == 0).all()
        assert (small.view(torch.int32) & 0x1FFF == 0).all()
        # big rounds to nearest: |x - big| <= 2^-11 |x|; small, cut toward
        # zero, keeps x - big to under 2^-10 of itself
        assert ((x.double() - big.double()).abs()
                <= 2.0 ** -11 * x.double().abs()).all()
        err = (x.double() - big.double() - small.double()).abs()
        assert (err <= 2.0 ** -21 * x.double().abs()).all()
        # one rounding alone keeps about 2^-11
        assert (x.double() - big.double()).abs().max() > \
            2.0 ** -14 * x.double().abs().max()


class TestF32BodyModel:
    @pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
    @pytest.mark.parametrize("s,h,kh,window,causal,cap,tile", CASES)
    def test_matches_jax_kernel_interpret(self, hd, s, h, kh, window,
                                          causal, cap, tile):
        q, k, v = _qkv(hd + s + window, s, h, kh, hd)
        kw = {"causal": causal, "window": window, "softcap": cap}
        port = tref.flash_attention_f32_tc_ref(
            *map(torch.from_numpy, (q, k, v)), **kw)
        np.testing.assert_allclose(port.numpy(), _pallas(q, k, v, tile, **kw),
                                   **TOL)

    @pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
    @pytest.mark.parametrize("case", [0, 2])
    def test_lse_matches_the_vjp_residual(self, hd, case):
        # the residual of the reference's _flash_vjp_fwd (out, lse), which
        # the f32 training path asks the kernel for
        s, h, kh, window, causal, cap, tile = CASES[case]
        q, k, v = _qkv(hd + s + 1, s, h, kh, hd)
        cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=64,
                          n_heads=h, n_kv_heads=kh, d_ff=64, vocab_size=64,
                          attn_logit_softcap=cap, dtype="float32")
        _, res = jattn._flash_vjp_fwd(cfg, *map(jnp.asarray, (q, k, v)),
                                      window, causal, tile, tile)
        port, lse = tref.flash_attention_f32_tc_ref(
            *map(torch.from_numpy, (q, k, v)), causal=causal, window=window,
            softcap=cap, return_lse=True)
        assert lse.shape == res[4].shape == (1, kh, h // kh, s)
        np.testing.assert_allclose(lse.numpy(), np.asarray(res[4]), **TOL)
        np.testing.assert_allclose(port.reshape(1, s, -1).numpy(),
                                   np.asarray(res[3]), **TOL)

    @pytest.mark.parametrize("hd", [64, 256])
    def test_single_pass_tf32_fails_the_f32_gate(self, hd):
        # the same inputs through one TF32 product each: about three
        # decimal digits, far outside 1e-5, where the split passes
        s, h, kh, window, causal, cap, tile = CASES[0]
        q, k, v = _qkv(hd + s + window, s, h, kh, hd)
        kw = {"causal": causal, "window": window, "softcap": cap}
        want = _pallas(q, k, v, tile, **kw)
        x = tuple(map(torch.from_numpy, (q, k, v)))
        split = tref.flash_attention_f32_tc_ref(*x, **kw).numpy()
        single = tref.flash_attention_f32_tc_ref(*x, split=False,
                                                 **kw).numpy()
        np.testing.assert_allclose(split, want, **TOL)
        assert not np.allclose(single, want, **TOL)
        assert np.abs(single - want).max() > 100 * np.abs(split - want).max()

    def test_walks_the_kernel_tiles(self):
        # the body's tiles (kBlockQ, Tf32Tile's BK): four warps of 16 rows,
        # key tiles that keep two blocks an SM
        assert [tref.f32_tc_tiles(hd) for hd in tfa.HEAD_DIMS] == [
            (64, 32), (64, 32), (64, 32), (64, 32), (64, 32), (64, 16),
            (64, 8)]

    def test_rows_that_admit_no_key_and_a_ragged_t(self):
        # a window of 1 key over a query tile that starts past the first
        # key tile, and T not a multiple of the key tile: the plain version
        # (f32 throughout) within the gate, lse included
        q, k, v = map(torch.from_numpy, _qkv(7, 75, 2, 1, 32))
        for kw in ({"causal": True, "window": 1},
                   {"causal": False, "window": 0, "softcap": 20.0}):
            out, lse = tref.flash_attention_f32_tc_ref(q, k, v,
                                                       return_lse=True, **kw)
            plain, plain_lse = tref.flash_attention_ref(q, k, v,
                                                        return_lse=True, **kw)
            torch.testing.assert_close(out, plain, **TOL)
            torch.testing.assert_close(lse, plain_lse, **TOL)

    def test_refuses_what_the_body_does_not_take(self):
        q, k, v = map(torch.from_numpy, _qkv(0, 8, 2, 1, 12))
        with pytest.raises(ValueError, match="multiple of 8"):
            tref.flash_attention_f32_tc_ref(q, k, v)
        with pytest.raises(ValueError, match="float32"):
            tref.flash_attention_f32_tc_ref(*(x.double() for x in
                                              (q, k, v)))
