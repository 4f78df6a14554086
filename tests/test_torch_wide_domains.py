"""The WKV and flash kernels' last domains: the WKV at any K and V (widths
up to 128 at the next of 32, 64 and 128 with zero columns, past 128 at the
next multiple of 32 cut into tiles), and flash attention at any head dim
past 256 (depth boxes of 64 columns, value slices).  On the CPU: the port's
plain versions, which the wrappers take for a CPU tensor, and the CPU
models of the kernels' new tilings, against the JAX reference on the same
seeded numpy inputs.  The CUDA kernels themselves are checked on the card
by chip_smoke.py.

Tolerances.  WKV: the f32 chunked forms against the reference's Pallas
kernel and its recurrence at atol 5e-4 (f32 chunked forms differ by up to
~3e-4 in single elements) and rtol 1e-5; a bf16 output one bf16 step
relative to the output on top.  Zero columns: bit for bit, on inputs where
every product and sum is exact in f32.  Flash: the plain version at atol
1e-5 plus one step of its type relative to the output, as
test_torch_kernel_domains; the 16-bit body's tile model, which rounds P to
bf16 before P V where the Pallas kernel keeps it f32, at one bf16 step
relative plus 2^-8 of the largest |v| (a 2^-8 relative rounding of each
p_j moves the output by at most that); the f32 body's model at rtol = atol
= 1e-5 (test_torch_flash_f32); the lse against ``_flash_vjp_fwd``'s
residual at 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.base import ModelConfig
from repro.kernels import flash_attention as jfa
from repro.kernels.rwkv6_wkv import wkv_chunked_pallas
from repro.models import attention as jattn
from repro.models import rwkv6 as jrwkv
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_wkv as twkv

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# one step of each type at 1: 2^-(mantissa bits)
STEP = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7}
WKV_ATOL = 5e-4
WKV_TOL = {"rtol": 1e-5, "atol": WKV_ATOL}
# (K, V): one of each kind of width, past 128 too
WKV_WIDTHS = [(1, 1), (17, 40), (48, 96), (160, 96), (256, 256)]
# past 128 on both sides and tiles of 32, 64 and 128
SLICED_WIDTHS = [(160, 96), (96, 160), (256, 256), (288, 200)]


def _wkv_inputs(seed, b, s, h, kk, vv):
    """The reference suite's distributions: r, k, v ~ N(0,1), logw =
    -exp(N(0,1)), u ~ 0.5 N(0,1), state0 ~ 0.1 N(0,1), as f32 numpy."""
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((b, s, h, kk), dtype=np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, vv), dtype=np.float32)
    w = -np.exp(rng.standard_normal((b, s, h, kk), dtype=np.float32))
    u = 0.5 * rng.standard_normal((h, kk), dtype=np.float32)
    s0 = 0.1 * rng.standard_normal((b, h, kk, vv), dtype=np.float32)
    return r, k, v, w, u, s0


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _f32(t):
    return t.detach().float().numpy()


def _padded(xt):
    """r, k, v, logw, u, state0 with zero columns to the kernel's padded
    widths (``twkv.padded_width``)."""
    r, k, v, w, u, s0 = xt
    kk, vv = r.shape[-1], v.shape[-1]
    dk = twkv.padded_width(kk) - kk
    dv = twkv.padded_width(vv) - vv
    return (F.pad(r, (0, dk)), F.pad(k, (0, dk)), F.pad(v, (0, dv)),
            F.pad(w, (0, dk)), F.pad(u, (0, dk)), F.pad(s0, (0, dv, 0, dk)))


def _tiles(kk, vv):
    return (twkv.tile_width(twkv.padded_width(kk), key=True),
            twkv.tile_width(twkv.padded_width(vv)))


class TestWkvAnyWidth:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("kk,vv", WKV_WIDTHS)
    def test_op_matches_jax_kernel_interpret(self, kk, vv, dtype):
        """Any K and V through the port's op (the chunked form on the CPU)
        against the reference's Pallas kernel, out in r's type and the
        state in f32; in f32 also against JAX's recurrence."""
        x = _wkv_inputs(7 * kk + vv, 1, 48, 2, kk, vv)
        port = ops.rwkv6_wkv_op(*(torch.from_numpy(a).to(dtype) for a in x))
        want = wkv_chunked_pallas(*(jnp.asarray(a).astype(JNP[dtype])
                                    for a in x), chunk=16, interpret=True)
        assert port[0].dtype == dtype and port[1].dtype == torch.float32
        assert port[0].shape == x[2].shape and port[1].shape == x[5].shape
        np.testing.assert_allclose(_f32(port[0]), _np(want[0]),
                                   rtol=max(STEP[dtype], 1e-5), atol=WKV_ATOL)
        np.testing.assert_allclose(_f32(port[1]), _np(want[1]), **WKV_TOL)
        if dtype == torch.float32:
            exact = jrwkv.wkv_recurrent(*map(jnp.asarray, x))
            for p, w in zip(port, exact):
                np.testing.assert_allclose(_f32(p), np.asarray(w), **WKV_TOL)

    @pytest.mark.parametrize("kk,vv", SLICED_WIDTHS)
    def test_sliced_two_pass_matches_jax(self, kk, vv):
        """The kernel's split at its padded widths and tiles: the state
        pass a key slice at a time, the output pass a value slice at a time
        walking the key slices (``ref.rwkv6_wkv_two_pass_ref`` with the
        tiles), sliced back, against JAX's chunked form and recurrence;
        the chunk-start states against the recurrence over each chunk's
        prefix."""
        s = 64
        x = _wkv_inputs(kk * vv + 1, 1, s, 2, kk, vv)
        xt = [torch.from_numpy(a) for a in x]
        k_tile, v_tile = _tiles(kk, vv)
        pad = _padded(xt)
        out, state = tref.rwkv6_wkv_two_pass_ref(*pad, k_tile=k_tile,
                                                 v_tile=v_tile)
        out, state = out[..., :vv], state[:, :, :kk, :vv]
        for want in (jrwkv.wkv_chunked(*map(jnp.asarray, x)),
                     jrwkv.wkv_recurrent(*map(jnp.asarray, x))):
            for p, w in zip((out, state), want):
                np.testing.assert_allclose(p.numpy(), np.asarray(w),
                                           **WKV_TOL)
        starts, _ = tref.wkv_chunk_states_ref(*pad[1:4], pad[5],
                                              k_tile=k_tile)
        assert starts.shape == twkv.scratch_shape(1, s, 2, kk, vv)
        np.testing.assert_allclose(starts[:, :, 0, :kk, :vv].numpy(), x[5])
        # the state at the start of chunk 1: the recurrence over chunk 0
        _, mid = jrwkv.wkv_recurrent(*(jnp.asarray(a[:, :twkv.CHUNK])
                                       for a in x[:4]), *map(jnp.asarray,
                                                             x[4:]))
        np.testing.assert_allclose(starts[:, :, 1, :kk, :vv].numpy(),
                                   np.asarray(mid), **WKV_TOL)
        # the padded rows and columns of every chunk-start state stay 0
        assert not starts[:, :, :, kk:].any()
        assert not starts[:, :, :, :, vv:].any()

    @pytest.mark.parametrize("kk,vv", [(1, 1), (17, 40), (48, 96),
                                       (160, 96), (256, 256)])
    def test_zero_columns_change_nothing(self, kk, vv):
        """Zero columns (r = k = logw = u = 0 and state0 rows 0 at a padded
        key; v = 0 at a padded value) leave out and the state unchanged,
        bit for bit: the chunked form (the op on the CPU) and the kernel's
        two-pass split at its tiles, on the padded inputs and sliced back,
        against the unpadded chunked form.  The inputs lie on a grid of
        2^-2 with logw 0 (decay 1), so every product and sum is exact in
        f32 and the order of summation cannot hide a column that added
        anything."""
        rng = np.random.default_rng(kk + 3 * vv)
        b, s, h = 1, 40, 2

        def grid(*shape):
            return torch.from_numpy(
                rng.integers(-4, 5, shape).astype(np.float32) / 4)

        xt = [grid(b, s, h, kk), grid(b, s, h, kk), grid(b, s, h, vv),
              torch.zeros(b, s, h, kk), grid(h, kk), grid(b, h, kk, vv)]
        want = tref.rwkv6_wkv_chunked_ref(*xt)
        k_tile, v_tile = _tiles(kk, vv)
        pad = _padded(xt)
        for got in (tref.rwkv6_wkv_chunked_ref(*pad),
                    tref.rwkv6_wkv_two_pass_ref(*pad, k_tile=k_tile,
                                                v_tile=v_tile)):
            assert torch.equal(got[0][..., :vv], want[0])
            assert torch.equal(got[1][:, :, :kk, :vv], want[1])
            assert not got[0][..., vv:].any()
            assert not got[1][:, :, kk:].any()
            assert not got[1][:, :, :, vv:].any()

    def test_width_rule(self):
        """Every width from 1 to 1024: up to 128 the next of 32, 64 and
        128, past it the next multiple of 32, cut into tiles of the largest
        of 128, 64 and 32 that divides it (K: of 64 and 32); the scratch at
        the padded widths."""
        for w in range(1, 1025):
            wp = twkv.padded_width(w)
            assert wp >= w
            if w <= 128:
                assert wp == min(t for t in twkv.WIDTHS if t >= w)
                assert twkv.tile_width(wp) == wp
                assert twkv.tile_width(wp, key=True) == wp
                continue
            assert wp == -(-w // 32) * 32
            for key, tiles in ((False, twkv.WIDTHS), (True, (32, 64))):
                t = twkv.tile_width(wp, key=key)
                assert t in tiles and wp % t == 0
                assert all(wp % u for u in tiles if u > t)
        assert twkv.scratch_shape(8, 4096, 8, 250, 17) == (8, 8, 128, 256, 32)
        with pytest.raises(ValueError):
            twkv.tile_width(48)


def _qkv(seed, b, s, h, kh, hd):
    rng = np.random.default_rng(seed)
    q = 2.0 * rng.standard_normal((b, s, h, hd), dtype=np.float32)
    k, v = (rng.standard_normal((b, s, kh, hd), dtype=np.float32)
            for _ in range(2))
    return q, k, v


# (H, Kh, causal, window, softcap): causal under GQA; windowed with a
# softcap (and GQA)
FLASH_MODES = [(4, 2, True, 0, 0.0), (4, 1, True, 12, 30.0)]


class TestFlashPast256:
    @pytest.mark.parametrize("mode", FLASH_MODES)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("hd", [264, 320, 512])
    def test_matches_jax_kernel_interpret(self, hd, dtype, mode):
        """The port's flash (the plain version on the CPU) and the CPU
        model of the body that runs it on the card (bf16: the wide 16-bit
        body's walk, ``ref.flash_attention_tiled_ref``: 64-key tiles, S
        summed over 64-column depth boxes, P rounded to bf16, P V by
        256-column value slices; f32: ``ref.flash_attention_f32_tc_ref``,
        3xTF32 over 32-key tiles) against the reference's Pallas kernel."""
        h, kh, causal, window, cap = mode
        s = 48
        q, k, v = _qkv(hd + window, 1, s, h, kh, hd)
        kw = {"causal": causal, "window": window, "softcap": cap}
        xt = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
        port = tfa.flash_attention(*xt, **kw)
        want = jfa.flash_attention_pallas(
            *(jnp.asarray(a).astype(JNP[dtype]) for a in (q, k, v)), cq=16,
            ck=16, interpret=True, **kw)
        assert port.dtype == dtype and port.shape == q.shape
        np.testing.assert_allclose(_f32(port), _np(want), rtol=STEP[dtype],
                                   atol=1e-5)
        if dtype == torch.bfloat16:
            model = tref.flash_attention_tiled_ref(*xt, **kw)
            assert model.dtype == dtype
            np.testing.assert_allclose(
                _f32(model), _np(want), rtol=STEP[dtype],
                atol=2.0 ** -8 * np.abs(v).max() + 1e-5)
        else:
            model = tref.flash_attention_f32_tc_ref(*xt, **kw)
            np.testing.assert_allclose(model.numpy(), _np(want), rtol=1e-5,
                                       atol=1e-5)

    def test_tile_model_walks_boxes_and_slices(self):
        """The wide 16-bit model at hd 520 (a last depth box of 8 columns,
        value slices of 256, 256 and 8): its f32 walk (P not rounded) equals
        the plain version to f32 rounding, and in bf16 each P rounding shows
        against it only at the bf16 scale."""
        hd, s = 520, 40
        q, k, v = map(torch.from_numpy, _qkv(5, 1, s, 2, 1, hd))
        plain = tref.flash_attention_ref(q, k, v, window=24)
        model = tref.flash_attention_tiled_ref(q, k, v, window=24)
        torch.testing.assert_close(model, plain, rtol=1e-5, atol=1e-5)
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        got = tref.flash_attention_tiled_ref(qb, kb, vb, window=24).float()
        want = tref.flash_attention_ref(qb, kb, vb, window=24).float()
        err = (got - want).abs().max().item()
        assert 0 < err <= 2.0 ** -8 * vb.float().abs().max().item() + 2e-2

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_lse_at_320_matches_the_vjp_residual(self, dtype):
        """hd 320: the plain version's and the body's model's lse (the
        training path's residual) against ``_flash_vjp_fwd``'s, f32
        inputs; the output too (in bf16 the model's output, whose P is
        rounded, at the bf16 bound)."""
        hd, s, h, kh, window = 320, 48, 4, 2, 20
        q, k, v = _qkv(hd, 1, s, h, kh, hd)
        cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=64,
                          n_heads=h, n_kv_heads=kh, d_ff=64, vocab_size=64,
                          dtype="float32")
        _, res = jattn._flash_vjp_fwd(cfg, *map(jnp.asarray, (q, k, v)),
                                      window, True, 16, 16)
        xt = [torch.from_numpy(a) for a in (q, k, v)]
        model = (tref.flash_attention_f32_tc_ref if dtype == torch.float32
                 else tref.flash_attention_tiled_ref)
        for fn in (tref.flash_attention_ref, model):
            out, lse = fn(*xt, window=window, return_lse=True)
            assert lse.shape == res[4].shape == (1, kh, h // kh, s)
            np.testing.assert_allclose(lse.numpy(), np.asarray(res[4]),
                                       atol=1e-5)
            np.testing.assert_allclose(out.reshape(1, s, -1).numpy(),
                                       np.asarray(res[3]), atol=1e-5)

    def test_pad_rule_for_every_head_dim(self):
        """Every hd from 1 to 1024: up to 256 the least built head dim at
        or above it, past 256 the next multiple of 64; q, k and v laid out
        at the padded head dim up to 256, past it at the next multiple of 8
        (the kernel's maps zero-fill the rest), zero columns added and the
        scale of hd kept, a width that needs none passed through."""
        for hd in range(1, 1025):
            if hd <= 256:
                to = min(b for b in tfa.HEAD_DIMS if b >= hd)
                row = to
            else:
                to = -(-hd // 64) * 64
                row = -(-hd // 8) * 8
            assert tfa.padded_head_dim(hd) == to
            assert tfa.row_width(hd) == row
            q, k, v = (torch.full((1, 2, 1, hd), float(i + 1))
                       for i in range(3))
            qp, kp, vp, scale = tfa.pad_head_dim(q, k, v)
            assert scale == hd ** -0.5
            if row == hd:
                assert qp is q and kp is k and vp is v
                continue
            for x, xp in ((q, qp), (k, kp), (v, vp)):
                assert xp.shape == (1, 2, 1, row) and xp.is_contiguous()
                assert torch.equal(xp[..., :hd], x)
                assert not xp[..., hd:].any()

    @pytest.mark.parametrize("hd", [264, 300, 1024])
    def test_attend_takes_the_head_dim(self, hd):
        """``attend`` passes every check up to the device's for a head dim
        past 256 (on CPU tensors it raises there, launching nothing)."""
        q, k, v = (torch.zeros(1, 8, 2, hd) for _ in range(3))
        before = tfa.FLASH.launches
        with pytest.raises(RuntimeError, match="one card"):
            tfa.attend(q, k, v)
        assert tfa.FLASH.launches == before
