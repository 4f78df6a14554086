"""The port's kernel modules (``repro_torch.kernels``) against the JAX
reference on the same numpy inputs, on the CPU.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
side runs its oracles and its Pallas kernels in interpret mode.  Bags and
the interaction are held at f32 rtol=1e-5, atol=1e-6: both sides sum in
f32 in different orders.  Flash attention is held at f32 atol=1e-5 against
the interpret-mode Pallas kernel, whose online softmax sums in another
order.  The RWKV-6 WKV's chunked forms are held at atol 5e-4 (the reference
suite's own tolerance) and a relative Frobenius error of 1e-5, its
recurrences at 1e-5 (see ``WKV_TOL``).  The CUDA kernels
themselves are checked on the card by chip_smoke.py.
"""
import ast
import ctypes
import inspect
from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig
from repro.kernels import dot_interaction as jdot
from repro.kernels import embedding_bag as jeb
from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import rwkv6 as jrwkv
from repro_torch.kernels import _build, ops
from repro_torch.kernels import dot_interaction as tdot
from repro_torch.kernels import embedding_bag as teb
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_wkv as twkv

TOL = {"rtol": 1e-5, "atol": 1e-6}
ROOT = Path(__file__).resolve().parents[1]


def _stack(seed, t=3, r=40, s=8, b=12, hot=5, p_mask=0.7):
    rng = np.random.default_rng(seed)
    tables = rng.standard_normal((t, r, s), dtype=np.float32)
    idx = rng.integers(0, r, size=(b, t, hot), dtype=np.int32)
    mask = (rng.random((b, t, hot)) < p_mask).astype(np.float32)
    return tables, idx, mask


def _close(port, jax_out):
    np.testing.assert_allclose(port.numpy(), np.asarray(jax_out), **TOL)


class TestEmbeddingBag:
    @pytest.mark.parametrize("seed,hot", [(0, 1), (1, 5), (2, 33)])
    def test_stacked_matches_jax_ref(self, seed, hot):
        tables, idx, mask = _stack(seed, hot=hot)
        port = teb.embedding_bag_stacked(*map(torch.from_numpy,
                                              (tables, idx, mask)))
        _close(port, jref.embedding_bag_stacked_ref(tables, idx, mask))

    @pytest.mark.parametrize("row_block", [0, 16])
    def test_stacked_matches_jax_kernel_interpret(self, row_block):
        tables, idx, mask = _stack(3, r=48, hot=4)
        port = teb.embedding_bag_stacked(
            *map(torch.from_numpy, (tables, idx, mask)), row_block=row_block)
        out = jeb.embedding_bag_stacked(
            jnp.asarray(tables), jnp.asarray(idx), jnp.asarray(mask),
            row_block=row_block, interpret=True)
        _close(port, out)

    def test_rows_matches_jax_kernel_interpret(self):
        tables, idx, mask = _stack(4, r=32, hot=6)
        rng = np.random.default_rng(4)
        n = 20
        tid = rng.integers(0, tables.shape[0], size=n, dtype=np.int32)
        ridx = rng.integers(0, 32, size=(n, 6), dtype=np.int32)
        rmask = (rng.random((n, 6)) < 0.6).astype(np.float32)
        port = teb.embedding_bag_rows(
            *map(torch.from_numpy, (tables, tid, ridx, rmask)))
        out = jeb.embedding_bag_rows(
            jnp.asarray(tables), jnp.asarray(tid), jnp.asarray(ridx),
            jnp.asarray(rmask), interpret=True)
        _close(port, out)
        _close(port, jref.embedding_bag_rows_ref(tables, tid, ridx, rmask))

    def test_single_table_matches_jax_ref(self):
        tables, idx, mask = _stack(5, hot=7)
        port = teb.embedding_bag(torch.from_numpy(tables[1]),
                                 torch.from_numpy(idx[:, 1]),
                                 torch.from_numpy(mask[:, 1]))
        _close(port, jref.embedding_bag_ref(tables[1], idx[:, 1],
                                            mask[:, 1]))

    def test_out_of_range_ids_clamp(self):
        tables, idx, mask = _stack(6, r=10, hot=4)
        wild = idx.copy()
        wild[:, :, 0] = -7
        wild[:, :, 1] = 10_000
        clamped = np.clip(wild, 0, tables.shape[1] - 1)
        port = teb.embedding_bag_stacked(
            *map(torch.from_numpy, (tables, wild, mask)))
        want = teb.embedding_bag_stacked(
            *map(torch.from_numpy, (tables, clamped, mask)))
        assert torch.equal(port, want)
        _close(port, jref.embedding_bag_stacked_ref(
            *map(jnp.asarray, (tables, wild, mask))))
        tid = np.array([-3, 0, 99], np.int32)
        rows = teb.embedding_bag_rows(
            torch.from_numpy(tables), torch.from_numpy(tid),
            torch.from_numpy(wild[:3, 0]), torch.from_numpy(mask[:3, 0]))
        _close(rows, jref.embedding_bag_rows_ref(
            *map(jnp.asarray, (tables, tid, wild[:3, 0], mask[:3, 0]))))

    def test_all_masked_bag_is_exact_zero(self):
        tables, idx, mask = _stack(7)
        mask[2] = 0.0
        mask[:, 1] = 0.0
        port = teb.embedding_bag_stacked(
            *map(torch.from_numpy, (tables, idx, mask)))
        assert torch.equal(port[2], torch.zeros_like(port[2]))
        assert torch.equal(port[:, 1], torch.zeros_like(port[:, 1]))

    @pytest.mark.parametrize("kw", [{"row_block": -2},
                                    {"pool_mode": "simd"}])
    def test_knobs_keep_the_reference_value_sets(self, kw):
        tables, idx, mask = _stack(8)
        with pytest.raises(ValueError):
            teb.embedding_bag_stacked(
                *map(torch.from_numpy, (tables, idx, mask)), **kw)

    @pytest.mark.parametrize("row_block,pool_mode",
                             [(-1, "scalar"), (0, "vector"), (8, "auto")])
    def test_knob_values_do_not_change_the_result(self, row_block,
                                                  pool_mode):
        tables, idx, mask = _stack(9)
        args = tuple(map(torch.from_numpy, (tables, idx, mask)))
        assert torch.equal(
            teb.embedding_bag_stacked(*args, row_block=row_block,
                                      pool_mode=pool_mode),
            teb.embedding_bag_stacked(*args))

    # the CPU model of the CUDA kernel's order (slots split over groups,
    # partial sums added in group order), on the smoke shapes above and a
    # hot-100 case at the served width s = 64, held at the kernel's own
    # rtol = atol = 1e-5: 50 unit-normal rows summed in two f32 orders
    # differ by up to ~5e-6
    @pytest.mark.parametrize("groups", [1, 2, 4, 8])
    @pytest.mark.parametrize("seed,hot,r,s", [(0, 1, 40, 8), (1, 5, 40, 8),
                                              (2, 33, 40, 8),
                                              (11, 100, 300, 64)])
    def test_split_model_matches_jax_ref(self, groups, seed, hot, r, s):
        tables, idx, mask = _stack(seed, r=r, s=s, hot=hot, p_mask=0.5)
        t, b = tables.shape[0], idx.shape[0]
        port = tref.embedding_bag_split_ref(
            torch.from_numpy(tables.reshape(t * r, s)),
            torch.from_numpy(idx.reshape(b * t, hot)),
            torch.from_numpy(mask.reshape(b * t, hot)),
            rows=r, n_tables=t, groups=groups)
        np.testing.assert_allclose(
            port.reshape(b, t, s).numpy(),
            np.asarray(jref.embedding_bag_stacked_ref(tables, idx, mask)),
            rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("groups", [1, 4])
    def test_split_model_rows_form_clamps_like_jax(self, groups):
        tables, idx, mask = _stack(12, r=32, hot=9)
        t, r, s = tables.shape
        tid = np.array([-3, 0, 2, 99, 1], np.int32)
        ridx = idx[:5, 0].copy()
        ridx[:, 0], ridx[:, 1] = -7, r + 10_000
        port = tref.embedding_bag_split_ref(
            torch.from_numpy(tables.reshape(t * r, s)),
            torch.from_numpy(ridx), torch.from_numpy(mask[:5, 0]),
            rows=r, n_tables=t, tid=torch.from_numpy(tid), groups=groups)
        _close(port, jref.embedding_bag_rows_ref(
            *map(jnp.asarray, (tables, tid, ridx, mask[:5, 0]))))

    def test_split_model_nan_row_under_zero_weight_stays_nan(self):
        tables, idx, mask = _stack(13, hot=6)
        t, r, s = tables.shape
        tables[1, 5] = np.nan
        idx[0, 1, 2], mask[0, 1, 2] = 5, 0.0
        args = (torch.from_numpy(tables.reshape(t * r, s)),
                torch.from_numpy(idx.reshape(-1, 6)),
                torch.from_numpy(mask.reshape(-1, 6)))
        got = tref.embedding_bag_split_ref(*args, rows=r, n_tables=t,
                                           groups=2).reshape(-1, t, s)
        plain = tref.embedding_bag_stacked_ref(
            *map(torch.from_numpy, (tables, idx, mask)))
        assert torch.isnan(got[0, 1]).all() and torch.isnan(plain[0, 1]).all()
        assert torch.equal(torch.isnan(got), torch.isnan(plain))

    def test_plan_is_not_ported(self):
        """Plans are ported (tests/test_torch_plans.py): what is not a
        plan of this call's geometry is refused with ValueError, and a
        resident call takes no plan."""
        tables, idx, mask = _stack(10)
        args = tuple(map(torch.from_numpy, (tables, idx, mask)))
        with pytest.raises(ValueError, match="StreamPlan"):
            teb.embedding_bag_stacked(*args, row_block=8, plan=object())
        t, r, s = tables.shape
        plan = teb.stacked_stream_plan(t, r, s, 4, args[1], row_block=8)
        with pytest.raises(ValueError, match="resident"):
            teb.embedding_bag_stacked(*args, plan=plan)
        assert torch.equal(
            teb.embedding_bag_stacked(*args, row_block=8, plan=plan),
            teb.embedding_bag_stacked(*args))


class TestDotInteraction:
    @pytest.mark.parametrize("b,f,s", [(16, 9, 16), (7, 27, 64),
                                       (5, 24, 8), (3, 2, 4)])
    def test_matches_jax_kernel_interpret(self, b, f, s):
        # features at the model's scale (|z| well under 1), so the f32
        # rounding of a 64-term dot stays inside atol
        z = 0.25 * np.random.default_rng(b * f).standard_normal(
            (b, f, s), dtype=np.float32)
        port = tdot.dot_interaction(torch.from_numpy(z))
        assert port.shape == (b, f * (f - 1) // 2)
        _close(port, jdot.dot_interaction(jnp.asarray(z), batch_tile=4,
                                          interpret=True))
        _close(port, jref.dot_interaction_ref(z))

    # the CPU model of the CUDA kernel's order (float4 columns split over
    # kparts threads, four fused multiply-add chains each, an xor tree over
    # threads)
    @pytest.mark.parametrize("kparts", [1, 2, 4])
    @pytest.mark.parametrize("b,f,s", [(16, 9, 16), (7, 27, 64), (5, 24, 8),
                                       (3, 2, 4)])
    def test_split_model_matches_jax(self, kparts, b, f, s):
        z = 0.25 * np.random.default_rng(b * f).standard_normal(
            (b, f, s), dtype=np.float32)
        port = tref.dot_interaction_split_ref(torch.from_numpy(z), kparts)
        _close(port, jdot.dot_interaction(jnp.asarray(z), batch_tile=4,
                                          interpret=True))
        _close(port, jref.dot_interaction_ref(z))

    def test_fma_model_rounds_once_where_float64_rounds_twice(self):
        # a * b + c = 1 + 2^-23 + 2^-24 - 2^-70: float64 rounds it to the
        # float32 midpoint 1 + 2^-23 + 2^-24, whose tie goes to the even
        # 1 + 2^-22; rounded once it is 1 + 2^-23
        a, b, c = (torch.tensor([x], dtype=torch.float32) for x in (
            2.0 ** -24 * (1 + 2.0 ** -23), 1 - 2.0 ** -23, 1 + 2.0 ** -23))
        assert (a.double() * b.double() + c.double()).float().item() \
            == 1 + 2.0 ** -22
        assert tref.fma_f32(a, b, c).item() == 1 + 2.0 ** -23

    @pytest.mark.parametrize("near_ties", [False, True])
    def test_fma_model_matches_exact_rounding(self, near_ties):
        # against a * b + c in exact rationals rounded to the nearest
        # float32 (ties to even); near_ties puts a * b within a few float32
        # ulps of half an ulp of c, where rounding twice goes wrong
        rng = np.random.default_rng(int(near_ties))
        n = 2000
        if near_ties:
            c = (1 + rng.integers(0, 1 << 23, n) * 2.0 ** -23)
            a = 2.0 ** -24 * (1 + rng.integers(-4, 5, n) * 2.0 ** -23)
            b = 1 + rng.integers(-4, 5, n) * 2.0 ** -23
            c = c * rng.choice([-1.0, 1.0], n)
        else:
            a = rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)
            b = rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)
            c = rng.standard_normal(n) * 2.0 ** rng.integers(-60, 60, n)
        a, b, c = (x.astype(np.float32) for x in (a, b, c))
        got = tref.fma_f32(*map(torch.from_numpy, (a, b, c))).numpy()

        def nearest(x):
            f = np.float32(float(x))
            cands = (f, np.nextafter(f, np.float32(np.inf)),
                     np.nextafter(f, np.float32(-np.inf)))
            return min(cands, key=lambda y: (
                abs(Fraction(float(y)) - x),
                int(np.frombuffer(y.tobytes(), np.uint32)[0]) & 1))

        want = np.array([nearest(Fraction(float(x)) * Fraction(float(y))
                                 + Fraction(float(z)))
                         for x, y, z in zip(a, b, c)], np.float32)
        np.testing.assert_array_equal(got, want)

    def test_pair_order_is_tril_row_major(self):
        # small integers: every dot is exact, so the order is all that
        # can differ
        f = 6
        z = np.random.default_rng(0).integers(-3, 4, size=(2, f, 5)) \
            .astype(np.float32)
        out = tdot.dot_interaction(torch.from_numpy(z)).numpy()
        gram = np.einsum("bfs,bgs->bfg", z, z)
        ii, jj = np.tril_indices(f, -1)
        np.testing.assert_array_equal(out, gram[:, ii, jj])
        assert list(zip(ii[:4], jj[:4])) == [(1, 0), (2, 0), (2, 1), (3, 0)]


def _qkv(seed, b, s, h, kh, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32)
                 for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))


class TestFlashAttention:
    # a subset of the reference's own sweep (tests/test_flash_kernel.py);
    # one interpret-mode call takes seconds here
    @pytest.mark.parametrize("h,kh,window,causal,softcap", [
        (4, 4, 0, True, 0.0), (4, 2, 32, True, 0.0), (8, 1, 0, False, 0.0),
        (4, 2, 0, True, 50.0), (8, 1, 32, True, 50.0), (4, 4, 0, False, 50.0),
    ])
    def test_matches_jax_kernel_interpret(self, h, kh, window, causal,
                                          softcap):
        q, k, v = _qkv(h * 10 + kh, 2, 128, h, kh, 16)
        port = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal, window=window,
                                   softcap=softcap)
        out = jfa.flash_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            window=window, softcap=softcap, cq=32, ck=32, interpret=True)
        np.testing.assert_allclose(port.numpy(), np.asarray(out), atol=1e-5)

    @pytest.mark.parametrize("h,kh,window,causal,softcap", [
        (4, 4, 0, True, 0.0), (4, 2, 24, True, 0.0), (8, 1, 0, False, 0.0),
        (4, 2, 0, True, 50.0), (4, 2, 24, False, 50.0),
    ])
    def test_plain_by_rows_matches_plain(self, h, kh, window, causal,
                                         softcap):
        # the plain version a block of query rows at a time (the card's
        # check at S 32768), against the whole plain version
        q, k, v = map(torch.from_numpy, _qkv(h + kh + window, 2, 100, h, kh,
                                             16))
        kw = {"causal": causal, "window": window, "softcap": softcap}
        got = tref.flash_attention_ref_rows(q, k, v, chunk=32, **kw)
        torch.testing.assert_close(got, tref.flash_attention_ref(q, k, v,
                                                                 **kw),
                                   rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("h,kh,causal", [(4, 4, True), (4, 2, False)])
    def test_hd80_matches_jax_kernel_interpret(self, h, kh, causal):
        # zamba2-2.7b's shared block attends at head dim 80
        q, k, v = _qkv(80 + h + kh, 2, 64, h, kh, 80)
        port = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal)
        out = jfa.flash_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            cq=32, ck=32, interpret=True)
        np.testing.assert_allclose(port.numpy(), np.asarray(out), atol=1e-5)

    @pytest.mark.parametrize("window,softcap", [(0, 0.0), (8, 50.0)])
    def test_padded_head_dim_matches_plain(self, window, softcap):
        """hd 8 (the smoke configs') reaches the kernel zero-padded to 16
        with the scale of hd 8: the plain version on the padded inputs
        holds the plain version at hd 8 and the interpret-mode Pallas
        kernel, and its padded output columns are zero."""
        q, k, v = map(torch.from_numpy, _qkv(8, 2, 32, 8, 2, 8))
        qp, kp, vp, scale = tfa.pad_head_dim(q, k, v)
        assert qp.shape[-1] == kp.shape[-1] == vp.shape[-1] == 16
        assert scale == 8 ** -0.5 and qp.is_contiguous()
        assert torch.equal(qp[..., :8], q) and not qp[..., 8:].any()
        kw = {"window": window, "softcap": softcap}
        padded = tref.flash_attention_ref(qp, kp, vp, scale=scale, **kw)
        assert not padded[..., 8:].any()
        plain = tref.flash_attention_ref(q, k, v, **kw)
        torch.testing.assert_close(padded[..., :8], plain, rtol=0,
                                   atol=1e-6)
        want = jfa.flash_attention_pallas(
            *(jnp.asarray(x.numpy()) for x in (q, k, v)), window=window,
            softcap=softcap, cq=16, ck=16, interpret=True)
        np.testing.assert_allclose(padded[..., :8].numpy(), np.asarray(want),
                                   atol=1e-5)
        # other head dims pass through untouched
        q16, k16, v16 = map(torch.from_numpy, _qkv(9, 1, 8, 2, 2, 16))
        assert tfa.pad_head_dim(q16, k16, v16)[0] is q16

    @pytest.mark.parametrize("s,window", [(45, 0), (77, 16)])
    def test_ragged_length_matches_jax_sdpa(self, s, window):
        # S not a multiple of the Pallas tile: the reference's kernel asserts
        # S % cq == 0, so hold the port against its dense _sdpa path
        q, k, v = _qkv(s, 2, s, 4, 2, 32)
        cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=64,
                          n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
                          attn_logit_softcap=50.0, dtype="float32")
        want = jattn._sdpa(cfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jattn.causal_mask(s, s, window))
        port = ops.flash_attention_op(*map(torch.from_numpy, (q, k, v)),
                                      window=window, softcap=50.0)
        np.testing.assert_allclose(port.reshape(2, s, -1).numpy(),
                                   np.asarray(want), atol=1e-5)

    # the CUDA body at hd 16 to 96 walks 128-query tiles over
    # ref.ws_block_k(hd) keys (64 at hd 16 and 32); its CPU model
    # (ref.flash_attention_tiled_ref) in f32 against the interpret-mode
    # Pallas kernel: (S, H, Kh, window, causal, softcap, the Pallas tile)
    TILED_CASES = [
        (256, 2, 2, 0, True, 0.0, 128),
        # S not a multiple of 128, GQA, not causal
        (288, 4, 2, 0, False, 0.0, 96),
        # the window's first live tile (keys 0-127; 64-127 at 64-key
        # tiles) admits no key of the query tile's rows past 134
        (288, 4, 1, 8, True, 0.0, 96),
        (160, 4, 2, 40, False, 30.0, 32),
    ]

    @pytest.mark.parametrize("hd", [16, 32, 64, 80, 96])
    @pytest.mark.parametrize("s,h,kh,window,causal,cap,tile", TILED_CASES)
    def test_tiled_model_matches_jax_kernel_interpret(self, hd, s, h, kh,
                                                      window, causal, cap,
                                                      tile):
        q, k, v = _qkv(hd + s + window, 1, s, h, kh, hd)
        kw = {"causal": causal, "window": window, "softcap": cap}
        port = tref.flash_attention_tiled_ref(
            *map(torch.from_numpy, (q, k, v)), **kw)
        out = jfa.flash_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cq=tile,
            ck=tile, interpret=True, **kw)
        np.testing.assert_allclose(port.numpy(), np.asarray(out), atol=1e-5)

    @pytest.mark.parametrize("hd", [16, 32, 64, 80, 96])
    @pytest.mark.parametrize("s,h,kh,window,causal,cap,tile", TILED_CASES)
    def test_tiled_model_lse_matches_the_vjp_residual(self, hd, s, h, kh,
                                                      window, causal, cap,
                                                      tile):
        # the residual of the reference's _flash_vjp_fwd (out, lse), which
        # the training path asks the kernel for
        q, k, v = _qkv(hd + s + window, 1, s, h, kh, hd)
        cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=64,
                          n_heads=h, n_kv_heads=kh, d_ff=64, vocab_size=64,
                          attn_logit_softcap=cap, dtype="float32")
        _, res = jattn._flash_vjp_fwd(cfg, *map(jnp.asarray, (q, k, v)),
                                      window, causal, tile, tile)
        port, lse = tref.flash_attention_tiled_ref(
            *map(torch.from_numpy, (q, k, v)), causal=causal, window=window,
            softcap=cap, return_lse=True)
        assert lse.shape == res[4].shape == (1, kh, h // kh, s)
        np.testing.assert_allclose(lse.numpy(), np.asarray(res[4]),
                                   atol=1e-5)
        np.testing.assert_allclose(port.reshape(1, s, -1).numpy(),
                                   np.asarray(res[3]), atol=1e-5)

    @pytest.mark.parametrize("hd", [16, 32, 64, 80, 96])
    def test_tiled_model_in_f16_matches_jax_kernel_interpret(self, hd):
        """The body's f16 instantiation: the tiled model on f16 inputs (P
        rounded to f16 before P V) against the Pallas kernel in f16, which
        keeps P in f32.  Rounding P moves the f32 output by at most half an
        f16 step (2^-11) of max |v|, and each side rounds its output once
        (half a step of |out| each): atol 2^-11 max |v| + 1e-5, rtol one
        f16 step, 2^-10."""
        s, h, kh, window, causal, cap, tile = self.TILED_CASES[3]
        q, k, v = (torch.from_numpy(a).half()
                   for a in _qkv(hd + s + 1, 1, s, h, kh, hd))
        kw = {"causal": causal, "window": window, "softcap": cap}
        port = tref.flash_attention_tiled_ref(q, k, v, **kw)
        out = jfa.flash_attention_pallas(
            *(jnp.asarray(x.numpy()) for x in (q, k, v)), cq=tile, ck=tile,
            interpret=True, **kw)
        assert port.dtype == torch.float16 and out.dtype == jnp.float16
        np.testing.assert_allclose(
            port.float().numpy(), np.asarray(out, dtype=np.float32),
            rtol=2.0 ** -10,
            atol=2.0 ** -11 * v.float().abs().max().item() + 1e-5)
        # the f32 model on the same (widened) inputs is the f16 one's
        # yardstick too: P rounded to f16 is the only other rounding
        wide = tref.flash_attention_tiled_ref(q.float(), k.float(),
                                              v.float(), **kw)
        np.testing.assert_allclose(
            port.float().numpy(), wide.numpy(), rtol=2.0 ** -10,
            atol=2.0 ** -11 * v.float().abs().max().item() + 1e-5)

    def test_bf16_stays_bf16(self):
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _qkv(5, 1, 40, 2, 1, 16))
        out = tfa.flash_attention(q, k, v, window=8)
        assert out.dtype == torch.bfloat16
        want = tref.flash_attention_ref(q.float(), k.float(), v.float(),
                                        window=8)
        torch.testing.assert_close(out.float(), want, rtol=0, atol=2e-2)

    # hd 264 runs on the body past 256 (any head dim runs: the CPU tensors
    # stop it at the device check) and float64 is outside the kernel's
    # types
    @pytest.mark.parametrize("change,err", [
        ({"hd": 264}, RuntimeError), ({"dtype": torch.float64},
                                      NotImplementedError),
        ({"kh": 3}, ValueError), ({"transpose": True}, ValueError),
    ])
    def test_launcher_rejects_what_the_kernel_does_not_take(self, change,
                                                            err):
        hd, kh = change.get("hd", 16), change.get("kh", 2)
        q, k, v = (torch.from_numpy(a).to(change.get("dtype", torch.float32))
                   for a in _qkv(6, 1, 8, 4, kh, hd))
        if change.get("transpose"):
            q = q.transpose(1, 2)
        with pytest.raises(err):
            tfa.attend(q, k, v)
        assert tfa.FLASH.launches == 0


def _wkv_inputs(seed, b, s, h, kk=64, logw=None, s0_scale=0.1,
                logw_mean=0.0):
    """The reference suite's distributions (tests/test_kernels.py), from
    numpy: r, k, v ~ N(0,1), logw = -exp(N(logw_mean,1)) (a constant
    ``logw`` when given), u ~ 0.5 N(0,1), and a nonzero state0."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, kk), dtype=np.float32)
               for _ in range(3))
    w = -np.exp(rng.standard_normal((b, s, h, kk), dtype=np.float32)
                + np.float32(logw_mean)) \
        if logw is None else np.full((b, s, h, kk), logw, np.float32)
    u = 0.5 * rng.standard_normal((h, kk), dtype=np.float32)
    s0 = s0_scale * rng.standard_normal((b, h, kk, kk), dtype=np.float32)
    return r, k, v, w, u, s0


# Each f32 chunked form (the port's, JAX's, the interpret-mode kernel)
# lies ~1.3e-6 (relative Frobenius) from a float64 recurrence on these
# inputs, but up to 2e-4 away in single elements of |out| up to ~90: the
# in-chunk decays are exponentials of differences of cumulative sums.  So
# the chunked forms are held elementwise at the reference suite's 5e-4 and
# as a whole at a relative Frobenius error of 1e-5; the two recurrences,
# which sum in the same order, at 1e-5 elementwise.
WKV_TOL = {"rtol": 1e-5, "atol": 5e-4}
WKV_REL = 1e-5
WKV_REC_TOL = {"rtol": 1e-5, "atol": 1e-5}
WKV_SHAPES = [(2, 64, 2, 16), (1, 128, 4, 32), (3, 96, 1, 32),
              (2, 256, 2, 64)]


def _close_pair(port, want, tol=WKV_TOL, rel=WKV_REL):
    for p, w in zip(port, want):
        p, w = p.numpy(), np.asarray(w)
        np.testing.assert_allclose(p, w, **tol)
        assert np.linalg.norm(p - w) <= rel * np.linalg.norm(w)


class TestRwkv6Wkv:
    @pytest.mark.parametrize("b,s,h,chunk", WKV_SHAPES)
    def test_plain_matches_jax_chunked(self, b, s, h, chunk):
        x = _wkv_inputs(b * s + h, b, s, h)
        port = tref.rwkv6_wkv_chunked_ref(*map(torch.from_numpy, x))
        _close_pair(port, jrwkv.wkv_chunked(*map(jnp.asarray, x), chunk=32))

    @pytest.mark.parametrize("b,s,h,chunk", WKV_SHAPES)
    def test_op_matches_jax_kernel_interpret(self, b, s, h, chunk):
        x = _wkv_inputs(b * s + h + 1, b, s, h)
        port = ops.rwkv6_wkv_op(*map(torch.from_numpy, x), chunk=chunk)
        want = jops.rwkv6_wkv_op(*map(jnp.asarray, x), chunk=chunk)
        _close_pair(port, want)

    @pytest.mark.parametrize("b,s,h,chunk", WKV_SHAPES[:2])
    def test_recurrence_matches_jax(self, b, s, h, chunk):
        x = _wkv_inputs(b * s + h + 2, b, s, h)
        rec = tref.rwkv6_wkv_ref(*map(torch.from_numpy, x))
        _close_pair(rec, jref.rwkv6_wkv_ref(*map(jnp.asarray, x)),
                    WKV_REC_TOL)
        chunked = twkv.rwkv6_wkv(*map(torch.from_numpy, x))
        _close_pair(chunked, [a.numpy() for a in rec])

    def test_extreme_decay_stays_finite_and_exact(self):
        # the state dies each step: upper-triangle exponents would be
        # +2200, so the mask must come before the exp
        x = _wkv_inputs(3, 1, 64, 1, logw=-50.0, s0_scale=0.0)
        port = twkv.rwkv6_wkv(*map(torch.from_numpy, x))
        assert torch.isfinite(port[0]).all()
        _close_pair(port, jref.rwkv6_wkv_ref(*map(jnp.asarray, x)),
                    {"rtol": 0.0, "atol": 1e-4})
        _close_pair(port, jops.rwkv6_wkv_op(*map(jnp.asarray, x), chunk=16),
                    {"rtol": 0.0, "atol": 1e-4})

    @pytest.mark.parametrize("s", [45, 7])
    def test_ragged_length_pads_exactly(self, s):
        x = tuple(map(torch.from_numpy, _wkv_inputs(s, 2, s, 2)))
        out, st = twkv.rwkv6_wkv(*x)
        assert out.shape == (2, s, 2, 64)
        _close_pair((out, st), [a.numpy() for a in tref.rwkv6_wkv_ref(*x)])

    # the CUDA kernel's split (a sequential state pass, then every chunk's
    # outputs from its chunk-start state) across the decay regimes, a
    # ragged S, state0 zero or not, and chunks of 32 and 64
    TWO_PASS_CASES = {
        "default": dict(b=2, s=64, h=2, chunk=32),
        "chunk64": dict(b=1, s=128, h=3, chunk=64),
        "long_memory": dict(b=2, s=96, h=2, chunk=32, logw_mean=-4.0),
        "extreme_decay": dict(b=1, s=64, h=2, chunk=32, logw=-50.0),
        "ragged": dict(b=2, s=45, h=2, chunk=32),
        "ragged_chunk64": dict(b=1, s=77, h=2, chunk=64, logw_mean=-4.0),
        "zero_state0": dict(b=1, s=64, h=2, chunk=64, s0_scale=0.0),
    }

    @staticmethod
    def _two_pass_inputs(case):
        kw = dict(TestRwkv6Wkv.TWO_PASS_CASES[case])
        b, s, h, chunk = (kw.pop(n) for n in ("b", "s", "h", "chunk"))
        return _wkv_inputs(sum(map(ord, case)), b, s, h, **kw), chunk

    @pytest.mark.parametrize("case", sorted(TWO_PASS_CASES))
    def test_two_pass_matches_jax(self, case):
        x, chunk = self._two_pass_inputs(case)
        port = tref.rwkv6_wkv_two_pass_ref(*map(torch.from_numpy, x),
                                           chunk=chunk)
        _close_pair(port, jrwkv.wkv_recurrent(*map(jnp.asarray, x)))
        if x[0].shape[1] % chunk == 0:
            _close_pair(port, jrwkv.wkv_chunked(*map(jnp.asarray, x),
                                                chunk=chunk))
        plain = tref.rwkv6_wkv_chunked_ref(*map(torch.from_numpy, x),
                                           chunk=chunk)
        _close_pair(port, [a.numpy() for a in plain])
        assert all(torch.isfinite(a).all() for a in port)

    @pytest.mark.parametrize("case", sorted(TWO_PASS_CASES))
    def test_two_pass_chunk_starts_are_the_recurrence_states(self, case):
        (r, k, v, w, u, s0), chunk = self._two_pass_inputs(case)
        starts, final = tref.wkv_chunk_states_ref(
            *map(torch.from_numpy, (k, v, w, s0)), chunk=chunk)
        n_chunks = -(-r.shape[1] // chunk)
        assert starts.shape == (r.shape[0], r.shape[2], n_chunks, 64, 64)
        np.testing.assert_array_equal(starts[:, :, 0].numpy(), s0)
        for c in range(1, n_chunks):
            t = c * chunk
            _, want = jrwkv.wkv_recurrent(*(jnp.asarray(a[:, :t])
                                            for a in (r, k, v, w)),
                                          jnp.asarray(u), jnp.asarray(s0))
            np.testing.assert_allclose(starts[:, :, c].numpy(),
                                       np.asarray(want), **WKV_TOL)
        _, want = jrwkv.wkv_recurrent(*map(jnp.asarray, (r, k, v, w, u, s0)))
        np.testing.assert_allclose(final.numpy(), np.asarray(want),
                                   **WKV_TOL)

    @pytest.mark.parametrize("b,s,h,kk,vv,chunks", [
        (1, 32768, 32, 64, 64, 1024), (2, 45, 3, 32, 128, 2),
        (1, 1, 1, 128, 64, 1)])
    def test_scratch_holds_one_state_per_chunk(self, b, s, h, kk, vv,
                                               chunks):
        assert twkv.scratch_shape(b, s, h, kk, vv) == (b, h, chunks, kk, vv)

    def test_bf16_u_is_taken_to_f32(self):
        r, k, v, w, u, s0 = map(torch.from_numpy, _wkv_inputs(4, 1, 32, 2))
        ub = u.to(torch.bfloat16)
        got = twkv.rwkv6_wkv(r, k, v, w, ub, s0)
        want = twkv.rwkv6_wkv(r, k, v, w, ub.float(), s0)
        assert got[0].dtype == torch.float32
        assert all(torch.equal(a, b) for a, b in zip(got, want))

    # K 48 and V 96 run zero-padded to 64 and 128 (any width runs: the CPU
    # tensors stop them at the device check); float64 is outside the
    # kernel's types
    @pytest.mark.parametrize("change,err", [
        ({"kk": 48}, RuntimeError), ({"vv": 96}, RuntimeError),
        ({"dtype": torch.float64}, NotImplementedError),
        ({"u_heads": 3}, ValueError), ({"state_b": 2}, ValueError),
        ({"transpose": True}, ValueError), ({}, RuntimeError),
    ])
    def test_launcher_rejects_what_the_kernel_does_not_take(self, change,
                                                            err):
        r, k, v, w, u, s0 = map(torch.from_numpy, _wkv_inputs(
            5, 1, 8, 2, kk=change.get("kk", 64)))
        r = r.to(change.get("dtype", torch.float32))
        if "vv" in change:
            v = torch.zeros(v.shape[:-1] + (change["vv"],))
            s0 = torch.zeros(s0.shape[:-1] + (change["vv"],))
        if "u_heads" in change:
            u = torch.zeros(change["u_heads"], u.shape[1])
        if "state_b" in change:
            s0 = s0.expand(change["state_b"], -1, -1, -1)
        if change.get("transpose"):
            k = k.transpose(1, 2).contiguous().transpose(1, 2)
        with pytest.raises(err):      # ({}: the CPU tensors themselves)
            twkv.wkv(r, k, v, w, u, s0)
        assert twkv.WKV.launches == 0


class TestDispatch:
    def test_pallas_on_cpu_raises(self):
        tables, idx, mask = _stack(11)
        args = tuple(map(torch.from_numpy, (tables, idx, mask)))
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.embedding_bag_stacked_op(*args, impl="pallas")
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.dot_interaction_op(torch.zeros(2, 3, 4), impl="pallas")
        q, k, v = map(torch.from_numpy, _qkv(0, 1, 8, 2, 1, 16))
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.flash_attention_op(q, k, v, impl="pallas")
        wkv_args = tuple(map(torch.from_numpy, _wkv_inputs(0, 1, 32, 1)))
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.rwkv6_wkv_op(*wkv_args, impl="pallas")

    def test_kernel_launchers_refuse_cpu_tensors(self):
        t = torch.zeros(8, 4)
        i = torch.zeros(2, 3, dtype=torch.int32)
        with pytest.raises(RuntimeError, match="CUDA"):
            teb.pool_rows(t, i, torch.zeros(2, 3), rows=8, n_tables=1)
        with pytest.raises(RuntimeError, match="CUDA"):
            tdot.interact(torch.zeros(2, 3, 4))
        with pytest.raises(RuntimeError, match="CUDA"):
            tfa.attend(*map(torch.from_numpy, _qkv(0, 1, 8, 2, 1, 16)))
        with pytest.raises(RuntimeError, match="CUDA"):
            twkv.wkv(*map(torch.from_numpy, _wkv_inputs(0, 1, 8, 1)))
        assert teb.POOL.launches == 0 and tdot.DOT.launches == 0
        assert tfa.FLASH.launches == 0 and twkv.WKV.launches == 0

    @pytest.mark.parametrize("impl", ["ref", "interpret", "auto"])
    def test_cpu_impls_take_the_plain_version(self, impl):
        tables, idx, mask = _stack(12)
        args = tuple(map(torch.from_numpy, (tables, idx, mask)))
        assert torch.equal(ops.embedding_bag_stacked_op(*args, impl=impl),
                           tref.embedding_bag_stacked_ref(*args))
        qkv = tuple(map(torch.from_numpy, _qkv(1, 1, 20, 4, 2, 16)))
        assert torch.equal(ops.flash_attention_op(*qkv, window=4, impl=impl),
                           tref.flash_attention_ref(*qkv, window=4))
        wkv_args = tuple(map(torch.from_numpy, _wkv_inputs(1, 1, 32, 2)))
        # 'ref' is the exact recurrence, as the reference's 'ref' forces its
        # oracle; the others the chunked form at the reference's chunk 64
        want = tref.rwkv6_wkv_ref(*wkv_args) if impl == "ref" else \
            tref.rwkv6_wkv_chunked_ref(*wkv_args, chunk=64)
        for got, w in zip(ops.rwkv6_wkv_op(*wkv_args, impl=impl), want):
            assert torch.equal(got, w)

    def test_rwkv6_ref_impl_is_the_recurrence(self):
        x = tuple(map(torch.from_numpy, _wkv_inputs(5, 2, 48, 2)))
        for got, want in zip(ops.rwkv6_wkv_op(*x, impl="ref"),
                             tref.rwkv6_wkv_ref(*x)):
            assert torch.equal(got, want)
        # and the reference's oracle, at the recurrence's tolerance
        _close_pair(ops.rwkv6_wkv_op(*x, impl="ref"),
                    jops.rwkv6_wkv_op(*map(jnp.asarray, x), impl="ref"),
                    WKV_REC_TOL)

    @pytest.mark.parametrize("impl", ["interpret", "auto"])
    @pytest.mark.parametrize("chunk", [16, 32, 64])
    def test_rwkv6_plain_path_honours_chunk(self, impl, chunk):
        x = tuple(map(torch.from_numpy, _wkv_inputs(6, 1, 80, 2)))
        for got, want in zip(ops.rwkv6_wkv_op(*x, impl=impl, chunk=chunk),
                             tref.rwkv6_wkv_chunked_ref(*x, chunk=chunk)):
            assert torch.equal(got, want)

    def test_ops_take_the_reference_keyword_set(self):
        """Every op takes the reference's keyword-only arguments with the
        reference's own defaults (read from ``repro.kernels.ops``), and
        gives the values it gives without them."""
        tables, idx, mask = _stack(13)
        targs = tuple(map(torch.from_numpy, (tables, idx, mask)))
        tid = torch.from_numpy(np.arange(6, dtype=np.int32) % 3)
        rows = (targs[0], tid, targs[1][:2].reshape(6, -1),
                targs[2][:2].reshape(6, -1))
        z = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (4, 5, 8), dtype=np.float32))
        qkv = tuple(map(torch.from_numpy, _qkv(2, 1, 24, 4, 2, 16)))
        wkv = tuple(map(torch.from_numpy, _wkv_inputs(2, 1, 64, 2)))
        calls = {
            "dot_interaction_op": ((z,), tref.dot_interaction_ref(z)),
            "embedding_bag_op": ((targs[0][0], targs[1][:, 0],
                                  targs[2][:, 0]),
                                 tref.embedding_bag_ref(
                                     targs[0][0], targs[1][:, 0],
                                     targs[2][:, 0])),
            "embedding_bag_stacked_op": (
                targs, tref.embedding_bag_stacked_ref(*targs)),
            "embedding_bag_rows_op": (rows,
                                      tref.embedding_bag_rows_ref(*rows)),
            "flash_attention_op": (qkv, tref.flash_attention_ref(*qkv)),
            "rwkv6_wkv_op": (wkv, tref.rwkv6_wkv_chunked_ref(*wkv,
                                                             chunk=64)),
        }
        for name, (args, want) in calls.items():
            sig = inspect.signature(getattr(jops, name))
            kw = {p.name: p.default for p in sig.parameters.values()
                  if p.kind is inspect.Parameter.KEYWORD_ONLY}
            assert kw, name
            got = getattr(ops, name)(*args, **kw)
            for g, w in zip(*((got, want) if isinstance(got, tuple)
                              else ((got,), (want,)))):
                assert torch.equal(g, w), name

    def test_tpu_knobs_change_no_value(self):
        tables, idx, mask = _stack(14)
        args = tuple(map(torch.from_numpy, (tables, idx, mask)))
        base = ops.embedding_bag_stacked_op(*args)
        for method in ("sort", "count", "auto"):
            assert torch.equal(ops.embedding_bag_stacked_op(
                *args, plan_method=method), base)
            assert torch.equal(ops.embedding_bag_op(
                args[0][0], args[1][:, 0], args[2][:, 0],
                plan_method=method), base[:, 0])
        qkv = tuple(map(torch.from_numpy, _qkv(3, 2, 40, 4, 1, 16)))
        base = ops.flash_attention_op(*qkv, causal=False)
        for cq, ck in ((256, 256), (16, 8), (1, 1024)):
            assert torch.equal(ops.flash_attention_op(
                *qkv, causal=False, cq=cq, ck=ck), base)
        with pytest.raises(ValueError, match="plan_method"):
            ops.embedding_bag_rows_op(args[0], args[1][:, 0, 0],
                                      args[1][:, 0], args[2][:, 0],
                                      plan_method="radix")
        with pytest.raises(ValueError, match="cq"):
            ops.flash_attention_op(*qkv, cq=0)
        wkv = tuple(map(torch.from_numpy, _wkv_inputs(3, 1, 32, 1)))
        with pytest.raises(ValueError, match="chunk"):
            ops.rwkv6_wkv_op(*wkv, chunk=0)

    def test_unknown_impl_raises(self):
        with pytest.raises(ValueError):
            ops.dot_interaction_op(torch.zeros(2, 3, 4), impl="triton")

    def test_reset_launches(self):
        for k in ops.kernels().values():
            k.launches = 3
            k.by_key["x"] = 3
        ops.reset_launches()
        assert all(k.launches == 0 and not k.by_key
                   for k in ops.kernels().values())

    def test_launches_count_by_key(self):
        # a stub entry point that reports success stands in for the library
        k = _build.Kernel("flash_attention.cu", "flash_attention_launch", [])
        k._fn = lambda *args: 0
        local, glob = tfa.launch_key(16, 8, 256, 4096), tfa.launch_key(
            16, 8, 256, 0)
        for key in (local, glob, local, None):
            k(0, key=key)
        assert k.launches == 4
        assert dict(k.by_key) == {local: 2, glob: 1}
        k.reset()
        assert k.launches == 0 and not k.by_key

    def test_kernel_argtypes_match_the_c_entry_points(self):
        # the C signatures: (table, idx, w, tid, out, n_bags, hot, s, rows,
        # n_tables, stream), (z, out, batch, f, s, stream), (q, k, v, out,
        # lse, dtype, b, s, t, h, kh, hd, causal, window, scale, softcap,
        # stream)
        # and (r, k, v, logw, u, state0, out, state, scratch, b, s, h, K,
        # V, dtype, wdtype, passes, stream)
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        f = ctypes.c_float
        assert teb.POOL.argtypes == [p] * 5 + [i64, i, i, i64, i, p]
        assert tdot.DOT.argtypes == [p, p, i, i, i, p]
        assert tfa.FLASH.argtypes == [p] * 5 + [i] * 9 + [f, f, p]
        assert twkv.WKV.argtypes == [p] * 9 + [i] * 8 + [p]
        for k in ops.kernels().values():
            src = (_build.CSRC / k.source).read_text()
            assert f'extern "C" int {k.symbol}(' in src
            assert "cudaGetLastError()" in src


class TestBuild:
    def test_build_targets_are_sm_90a_and_content_addressed(self):
        assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
        for src in _build.SOURCES:
            tgt = _build.target(src)
            assert tgt.parent == ROOT / "build" / "kernels"
            assert tgt.name.startswith(Path(src).stem + "-")

    def test_every_kernel_is_built_from_a_source(self):
        # the bag and the interaction have an f32 and a bf16 entry point
        # in one source each
        sources = [k.source for k in ops.kernels().values()]
        assert sorted(set(sources)) == sorted(_build.SOURCES)
        assert sorted(sources) == sorted(
            _build.SOURCES + ("embedding_bag.cu", "dot_interaction.cu"))
        assert "rwkv6_wkv.cu" in _build.SOURCES
        for src in _build.SOURCES:
            assert (_build.CSRC / src).is_file()

    def test_tensor_maps_need_no_driver_library(self):
        # the TMA kernels fetch cuTensorMapEncodeTiled through the runtime,
        # so the libraries link against the runtime alone
        assert "-lcuda" not in _build.NVCC_FLAGS
        for src in ("flash_attention.cu", "rwkv6_wkv.cu"):
            text = (_build.CSRC / src).read_text()
            assert "cuTensorMapEncodeTiled" in text
            assert "cudaGetDriverEntryPoint" in text

    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.nvcc()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_reference():
    # nor ml_dtypes: the card's machine has no bf16 numpy type, so host
    # copies of bf16 rows are their np.uint16 bit patterns
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    port = ROOT / "src" / "repro_torch"
    for new in ("runtime/placement.py", "runtime/reshard.py",
                "runtime/scrub.py", "core/integrity.py", "models/moe.py",
                "models/whisper.py", "configs/whisper_tiny.py",
                "examples/quickstart.py", "examples/serve_lm_decode.py",
                "kernels/flash_attention_bwd.py", "train/optimizer.py",
                "train/steps.py", "data/pipeline.py", "runtime/checkpoint.py",
                "launch/train.py", "examples/train_lm.py",
                "sharding/partition.py", "sharding/tp.py", "launch/specs.py",
                "launch/mesh.py", "train/grad_compression.py",
                "runtime/elastic.py", "examples/failure_recovery.py",
                "launch/dryrun.py", "launch/multihost.py"):
        assert port / new in files, new
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
                (path, mod)
