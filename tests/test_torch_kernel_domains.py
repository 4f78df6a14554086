"""The whole domain of the WKV and flash kernels (ROADMAP B items 3 and 4,
and the C4 repair): the port's plain versions, which the wrappers take for
a CPU tensor, against the JAX reference on the same seeded numpy inputs,
on the CPU.

WKV.  The reference's Pallas kernel widens r, k, v, logw, u and state0 to
f32, computes and returns the output in r's type and the state in f32; the
port's chunked forms do the same.  A 16-bit output is held at the f32
chunked forms' atol 5e-4 plus one step of its type relative to the output
(two f32 results a few 1e-6 apart may round to neighbouring values); the
state at the f32 forms' tolerance.  The exact recurrence (``impl="ref"``)
follows the reference's oracle, a ``lax.scan`` of jnp ops whose types
promote op by op: on bf16 inputs it is held at two bf16 steps relative to
the output's largest magnitude (XLA may fuse a chain of bf16 ops and round
once where torch rounds after every op).

Flash.  Head dims outside the built set reach the kernel zero-padded to
the next built one with the true head dim's scale; on the CPU the plain
version takes any head dim.  Held against the interpret-mode Pallas kernel
at atol 1e-5 plus one step of the input type relative to the output, and
the padded call's lse against the residual of the reference's
``_flash_vjp_fwd``.  The CUDA kernels themselves are checked on the card
by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig
from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels.rwkv6_wkv import wkv_chunked_pallas
from repro.models import attention as jattn
from repro.models import rwkv6 as jrwkv
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_wkv as twkv

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float16: jnp.float16}
# one step of each type at 1: 2^-(mantissa bits)
STEP = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7,
        torch.float16: 2.0 ** -10}
WKV_ATOL = 5e-4
WKV_TOL = {"rtol": 1e-5, "atol": WKV_ATOL}
WKV_WIDTHS = [(64, 64), (32, 128), (128, 128)]


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


class TestWkvTypes:
    @pytest.mark.parametrize("kk,vv", WKV_WIDTHS)
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
    def test_op_matches_jax_kernel_interpret(self, dtype, kk, vv):
        """C4: bf16 and f16 inputs through the port's op (the chunked form
        on the CPU) against the reference's Pallas kernel: the output in
        r's type, the state in f32."""
        x = _wkv_inputs(kk + 3 * vv, 1, 64, 2, kk, vv)
        port = ops.rwkv6_wkv_op(*(torch.from_numpy(a).to(dtype) for a in x))
        want = wkv_chunked_pallas(*(jnp.asarray(a).astype(JNP[dtype])
                                    for a in x), chunk=64, interpret=True)
        assert port[0].dtype == dtype and port[1].dtype == torch.float32
        assert want[0].dtype == JNP[dtype] and want[1].dtype == jnp.float32
        np.testing.assert_allclose(_f32(port[0]), _np(want[0]),
                                   rtol=STEP[dtype], atol=WKV_ATOL)
        np.testing.assert_allclose(_f32(port[1]), _np(want[1]), **WKV_TOL)

    @pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
    def test_recurrence_follows_the_jax_oracle(self, state_dtype):
        """``impl="ref"`` on bf16 inputs with an f32 state0 returns f32 out
        and state, with a bf16 state0 bf16, as the reference's oracle."""
        x = _wkv_inputs(7, 2, 48, 2, 64, 32)
        xt = [torch.from_numpy(a).to(torch.bfloat16) for a in x[:5]] + [
            torch.from_numpy(x[5]).to(state_dtype)]
        port = ops.rwkv6_wkv_op(*xt, impl="ref")
        want = jops.rwkv6_wkv_op(
            *(jnp.asarray(a).astype(jnp.bfloat16) for a in x[:5]),
            jnp.asarray(x[5]).astype(JNP[state_dtype]), impl="ref")
        assert port[0].dtype == port[1].dtype == state_dtype
        assert want[0].dtype == want[1].dtype == JNP[state_dtype]
        for p, w in zip(port, want):
            w = _np(w)
            np.testing.assert_allclose(
                _f32(p), w, rtol=0,
                atol=2 * STEP[torch.bfloat16] * np.abs(w).max())

    def test_grads_come_back_in_each_input_type(self):
        """``Rwkv6WkvFn`` on bf16 r, k, v, logw and u beside an f32 state0:
        bf16 gradients (f32 for state0), within one bf16 step of f32
        autograd on the widened inputs with the same cotangents."""
        x = _wkv_inputs(11, 1, 64, 2, 64, 64)
        rng = np.random.default_rng(12)
        # cotangents that bf16 holds exactly, so both runs see the same
        g_out = torch.from_numpy(rng.standard_normal(x[2].shape,
                                                     dtype=np.float32))
        g_out = g_out.to(torch.bfloat16).float()
        g_state = torch.from_numpy(rng.standard_normal(x[5].shape,
                                                       dtype=np.float32))

        bf16 = [torch.from_numpy(a).to(torch.bfloat16) for a in x[:5]]

        def grads(widen):
            xt = [(t.float() if widen else t.clone()).requires_grad_()
                  for t in bf16]
            xt.append(torch.from_numpy(x[5]).requires_grad_())
            out, state = ops.rwkv6_wkv_op(*xt)
            assert out.dtype == xt[0].dtype and state.dtype == torch.float32
            ((out.float() * g_out).sum() + (state * g_state).sum()).backward()
            return [t.grad for t in xt]

        for got, want in zip(grads(False), grads(True)):
            assert got.dtype == (torch.float32 if got.shape == x[5].shape
                                 else torch.bfloat16)
            torch.testing.assert_close(got.float(), want,
                                       rtol=STEP[got.dtype], atol=0)

    def test_mixed_types_round_once_to_r(self):
        """r, k and v of different types are widened, computed in f32 and
        rounded once to r's type; logw in a third type too."""
        x = [torch.from_numpy(a) for a in _wkv_inputs(13, 1, 40, 2, 32, 64)]
        mixed = [x[0].to(torch.bfloat16), x[1].to(torch.float16), x[2],
                 x[3].to(torch.float64), x[4], x[5].to(torch.bfloat16)]
        out, state = twkv.rwkv6_wkv(*mixed)
        want = tref.rwkv6_wkv_chunked_ref(*(t.float() for t in mixed))
        assert out.dtype == torch.bfloat16 and state.dtype == torch.float32
        assert torch.equal(out, want[0].to(torch.bfloat16))
        assert torch.equal(state, want[1])

    @pytest.mark.parametrize("kk,vv,s", [(32, 128, 64), (128, 32, 45),
                                         (64, 128, 77)])
    def test_two_pass_at_k_other_than_v(self, kk, vv, s):
        """The CUDA kernel's split at K != V (ragged S too) against JAX's
        recurrence, the chunk-start states shaped (B, H, n, K, V)."""
        x = _wkv_inputs(kk * vv + s, 2, s, 2, kk, vv)
        xt = [torch.from_numpy(a) for a in x]
        port = tref.rwkv6_wkv_two_pass_ref(*xt)
        want = jrwkv.wkv_recurrent(*map(jnp.asarray, x))
        for p, w in zip(port, want):
            np.testing.assert_allclose(p.numpy(), np.asarray(w), **WKV_TOL)
        starts, _ = tref.wkv_chunk_states_ref(*xt[1:4], xt[5])
        assert starts.shape == twkv.scratch_shape(2, s, 2, kk, vv)
        # 16-bit inputs: out in r's type, the f32 result rounded once
        xb = [t.to(torch.bfloat16) for t in xt]
        out, state = tref.rwkv6_wkv_two_pass_ref(*xb)
        wide = tref.rwkv6_wkv_two_pass_ref(*(t.float() for t in xb))
        assert out.dtype == torch.bfloat16 and state.dtype == torch.float32
        assert torch.equal(out, wide[0].to(torch.bfloat16))
        assert torch.equal(state, wide[1])


def _qkv(seed, b, s, h, kh, hd):
    rng = np.random.default_rng(seed)
    q = 2.0 * rng.standard_normal((b, s, h, hd), dtype=np.float32)
    k, v = (rng.standard_normal((b, s, kh, hd), dtype=np.float32)
            for _ in range(2))
    return q, k, v


# head dims outside HEAD_DIMS (96 is built), each padded to the next
# built one
FLASH_HDS = [24, 48, 88, 160]


class TestFlashDomain:
    @pytest.mark.parametrize("window", [0, 12])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
    @pytest.mark.parametrize("hd", FLASH_HDS)
    def test_matches_jax_kernel_interpret(self, hd, dtype, window):
        """Any head dim up to 256 and f16: the port's flash (the plain
        version on the CPU) against the reference's Pallas kernel, output
        in the input type."""
        q, k, v = _qkv(hd + window, 1, 32, 2, 1, hd)
        port = tfa.flash_attention(*(torch.from_numpy(a).to(dtype)
                                     for a in (q, k, v)), window=window)
        want = jfa.flash_attention_pallas(
            *(jnp.asarray(a).astype(JNP[dtype]) for a in (q, k, v)),
            window=window, cq=16, ck=16, interpret=True)
        assert port.dtype == dtype and want.dtype == JNP[dtype]
        np.testing.assert_allclose(_f32(port), _np(want), rtol=STEP[dtype],
                                   atol=1e-5)

    @pytest.mark.parametrize("hd", FLASH_HDS)
    def test_padded_call_and_lse_match_the_vjp_residual(self, hd):
        """The call the kernel gets: q, k, v zero-padded to the built head
        dim with the true hd's scale; its sliced output and lse (f32,
        causal, windowed) against ``_flash_vjp_fwd``'s residual."""
        s, h, kh, window = 48, 4, 2, 20
        q, k, v = _qkv(3 * hd, 1, s, h, kh, hd)
        qp, kp, vp, scale = tfa.pad_head_dim(*map(torch.from_numpy,
                                                  (q, k, v)))
        assert qp.shape[-1] == tfa.padded_head_dim(hd) > hd
        out, lse = tref.flash_attention_ref(qp, kp, vp, window=window,
                                            scale=scale, return_lse=True)
        assert not out[..., hd:].any()
        cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=64,
                          n_heads=h, n_kv_heads=kh, d_ff=64, vocab_size=64,
                          dtype="float32")
        _, res = jattn._flash_vjp_fwd(cfg, *map(jnp.asarray, (q, k, v)),
                                      window, True, 16, 16)
        np.testing.assert_allclose(lse.numpy(), np.asarray(res[4]),
                                   atol=1e-5)
        np.testing.assert_allclose(out[..., :hd].reshape(1, s, -1).numpy(),
                                   np.asarray(res[3]), atol=1e-5)

    def test_pad_rule_for_every_head_dim(self):
        """Every hd from 1 to 256 runs at the least built head dim at or
        above it, zero columns added and the scale of hd kept; a built one
        passes through; past 256 a head dim runs at the next multiple of 64
        (the body past 256), laid out at the next multiple of 8."""
        for hd in range(1, 257):
            to = min(b for b in tfa.HEAD_DIMS if b >= hd)
            assert tfa.padded_head_dim(hd) == to
            q, k, v = (torch.full((1, 2, 1, hd), float(i + 1))
                       for i in range(3))
            qp, kp, vp, scale = tfa.pad_head_dim(q, k, v)
            assert scale == hd ** -0.5
            if to == hd:
                assert qp is q and kp is k and vp is v
                continue
            for x, xp in ((q, qp), (k, kp), (v, vp)):
                assert xp.shape == (1, 2, 1, to) and xp.is_contiguous()
                assert torch.equal(xp[..., :hd], x)
                assert not xp[..., hd:].any()
        assert tfa.padded_head_dim(257) == 320
        q = torch.ones((1, 2, 1, 257))
        qp, _, _, scale = tfa.pad_head_dim(q, q, q)
        assert qp.shape[-1] == tfa.row_width(257) == 264
        assert scale == 257 ** -0.5 and not qp[..., 257:].any()
