"""Plain-PyTorch versions of the hand-written kernels (the port of
``repro/kernels/ref.py``).  The kernel wrappers take these for CPU tensors,
the tests hold the port against the reference with them, and
``chip_smoke.py`` compares every kernel with them on the card.

The WKV has two: the exact recurrence (the oracle, and the model's decode
path) and the chunked form (the CUDA kernel's plain version).  The bag, the
interaction and the WKV kernels also have a CPU model of the order in which
each kernel sums (``embedding_bag_split_ref``, ``dot_interaction_split_ref``,
``rwkv6_wkv_two_pass_ref``), and the flash kernel's hd 64/80/96 body and
its f32 body one each of their tile walks (``flash_attention_tiled_ref``,
``flash_attention_f32_tc_ref``, with ``tf32_round`` the model of the f32
body's TF32 rounding), held against the reference by the tests.

Ids are clamped to ``[0, R-1]`` (and table ids to ``[0, T-1]``) explicitly:
JAX clamps out-of-bounds gathers silently, torch indexing raises.

bf16 inputs: the bags and the interaction widen them to f32, compute in
f32 and round the result once to the input's type, as their kernels and
the reference's kernels do; a bf16 bag therefore differs from one summed
in bf16 (or from XLA's sum, in another order) by at most a rounding.  The
chunked WKV forms do the same for any float type (the reference's Pallas
kernel widens every input on load): the output comes back in r's type and
the state in f32.  The WKV recurrence follows the reference's oracle
instead: jnp's promotion, out and state in the promoted type.
"""
from __future__ import annotations

import math

import torch


def dot_interaction_ref(z: torch.Tensor) -> torch.Tensor:
    """z:(B,F,S) -> (B, F(F-1)/2) lower triangle of Z @ Z^T (reference DLRM
    interact_features), in ``np.tril_indices(F, -1)`` order."""
    _, f, _ = z.shape
    zf = z.float()
    zz = torch.bmm(zf, zf.transpose(1, 2))
    ii, jj = torch.tril_indices(f, f, -1, device=z.device)
    return zz[:, ii, jj].to(z.dtype)


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add, a * b + c rounded once (to nearest, ties
    to even), as the card's ``fmaf``.  The product of two float32 values is
    exact in float64; the float64 sum s and its error e (TwoSum) give the
    exact a * b + c = s + e.  Rounding s to float32 is then right unless s
    lies exactly halfway between two float32 values while e is not 0: the
    sign of e picks the side.  Finite values only."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.float()
    toward = torch.where(s > r.double(), torch.inf, -torch.inf).float()
    other = torch.nextafter(r, toward)
    tie = (s == (r.double() + other.double()) / 2) & (e != 0)
    side = torch.where(e > 0, torch.maximum(r, other),
                       torch.minimum(r, other))
    return torch.where(tie, side, r)


def dot_interaction_split_ref(z: torch.Tensor, kparts: int) -> torch.Tensor:
    """CPU model of the CUDA interaction kernel's summation order, bit-exact
    to its float4 schedule: the features are cut into float4 columns,
    thread kp of a pair's ``kparts`` (``dot_interaction.kparts`` reads the
    launcher's) takes columns kp, kp + kparts, ... and keeps one running
    fused multiply-add per float4 component from 0; each thread folds its
    four as (x + y) + (z + w), and the threads meet in an xor tree (1, 2, 4,
    ...).  S must be a multiple of 4.  bf16 features are widened to f32
    and each dot rounded once to bf16, as the bf16 entry point does."""
    b, f, s = z.shape
    zf = z.float().reshape(b, f, s // 4, 4)
    ii, jj = torch.tril_indices(f, f, -1, device=z.device)
    zi, zj = zf[:, ii], zf[:, jj]                            # (B, P, S/4, 4)
    parts = []
    for kp in range(kparts):
        acc = torch.zeros_like(zi[:, :, 0])                  # (B, P, 4)
        for v in range(kp, s // 4, kparts):
            acc = fma_f32(zi[:, :, v], zj[:, :, v], acc)
        parts.append((acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3]))
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0].to(z.dtype)


def clamped_ids(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Ids as int64, clamped to ``[0, n - 1]`` as the bags read them."""
    return idx.long().clamp(0, n - 1)


def _pool(rows, mask, dim: int):
    """Masked sum of gathered ``rows`` over ``dim``: the rows widened to
    f32, weighed by the f32 mask and summed in f32, the sum rounded once
    to the rows' type (a no-op cast for f32 tables)."""
    return (rows.float() * mask[..., None].float()).sum(dim).to(rows.dtype)


def embedding_bag_ref(table, idx, mask):
    """table:(R,S) idx:(B,hot) mask:(B,hot) -> (B,S) masked-sum bags."""
    rows = table[clamped_ids(idx, table.shape[0])]             # (B,hot,S)
    return _pool(rows, mask, 1)


def embedding_bag_stacked_ref(tables, idx, mask):
    """tables:(T,R,S) idx/mask:(B,T,hot) -> (B,T,S) per-table masked sums.
    Materializes the (B,T,hot,S) gather the kernel avoids."""
    t, r, _ = tables.shape
    tab = torch.arange(t, device=tables.device)[None, :, None]
    rows = tables[tab, clamped_ids(idx, r)]                      # (B,T,hot,S)
    return _pool(rows, mask, 2)


def embedding_bag_rows_ref(tables, tid, idx, mask):
    """tables:(T,R,S) tid:(N,) idx/mask:(N,hot) -> (N,S) masked sums, each
    row pooled against its own table."""
    t, r, _ = tables.shape
    rows = tables[clamped_ids(tid, t)[:, None], clamped_ids(idx, r)]
    return _pool(rows, mask, 1)


def embedding_bag_grad_ref(shape, dtype, gid, mask, dout):
    """The gradient of every bag form w.r.t. its table of ``shape`` (...,
    S): ``mask * dout`` scatter-added into the rows the forward read, a
    dense gradient in ``dtype``.  gid (..., hot) holds each slot's flat
    row in the table's (prod(shape[:-1]), S) row space (clamped as the
    forward clamps), mask (..., hot) its weight, dout (..., S) the bag's
    output gradient."""
    s = shape[-1]
    grad = torch.zeros((math.prod(shape[:-1]), s),
                       dtype=dtype, device=dout.device)
    vals = (mask[..., None].to(dout.dtype) * dout[..., None, :]).to(dtype)
    grad.index_add_(0, gid.reshape(-1), vals.reshape(-1, s))
    return grad.reshape(shape)


def dot_interaction_grad_ref(z, dout):
    """The gradient of :func:`dot_interaction_ref` w.r.t. z (B, F, S) for
    the output gradient dout (B, F(F-1)/2): dZ = (G + G^T) Z, G the (F, F)
    strict lower triangle that holds dout in ``np.tril_indices(F, -1)``
    order; in f32, returned in z's type."""
    b, f, _ = z.shape
    ii, jj = torch.tril_indices(f, f, -1, device=z.device)
    g = torch.zeros((b, f, f), dtype=torch.float32, device=z.device)
    g[:, ii, jj] = dout.float()
    return torch.bmm(g + g.transpose(1, 2), z.float()).to(z.dtype)


def embedding_bag_split_ref(table_flat, idx, w, *, rows: int, n_tables: int,
                            tid=None, groups: int = 1):
    """CPU model of the CUDA bag kernel's summation order, over the flat
    (n_tables * rows, s) row space as the kernel sees it: bag n pools
    against table clamp(tid[n]) (or n % n_tables without tid); its slots
    are split over ``groups`` groups, group k adding the rounded products
    of slots k, k + groups, ... in order to a sum that starts at 0, and the
    group sums are added in order 0, 1, ....  All of it in f32 (a bf16 row
    widened exactly, weighed by the f32 weight), the bag rounded once to
    the table's type.  Bit-exact to the kernel with the same ``groups``
    (``embedding_bag.launch_plan`` reads the kernel's)."""
    n, hot = idx.shape
    if tid is None:
        t = torch.arange(n, device=idx.device) % n_tables
    else:
        t = clamped_ids(tid, n_tables)
    x = table_flat[t[:, None] * rows + clamped_ids(idx, rows)].float() \
        * w[..., None].float()                                # (N, hot, s)
    out = None
    for k in range(groups):
        acc = torch.zeros((n, table_flat.shape[1]), dtype=torch.float32,
                          device=table_flat.device)
        for h in range(k, hot, groups):
            acc = acc + x[:, h]
        out = acc if out is None else out + acc
    return out.to(table_flat.dtype)


# the Pallas kernel's finite mask sentinel (flash_attention.py:22)
NEG_INF = -1e30


def _attend_rows(q, k, v, q0: int, k0: int, *, causal: bool, window: int,
                 softcap: float, scale):
    """Query rows ``q0 .. q0 + S - 1`` against keys ``k0 .. k0 + T - 1`` ->
    (out (B, Kh, G, S, hd) before the division, the rows' max, the clamped
    sum, the (S, T) admitted-key mask), in f32, or in f64 for f64 inputs."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    wide = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(wide).reshape(b, s, kh, h // kh, hd)
    sc = torch.einsum("bskgd,btkd->bkgst", qf, k.to(wide)).mul_(
        hd ** -0.5 if scale is None else scale)
    if softcap:
        sc.div_(softcap).tanh_().mul_(softcap)
    qi = torch.arange(q0, q0 + s, device=q.device)[:, None]
    kj = torch.arange(k0, k0 + t, device=q.device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kj <= qi
    if window:
        ok &= (qi - kj) < window
    sc.masked_fill_(~ok, NEG_INF)
    m = sc.amax(-1, keepdim=True)
    sc.sub_(m).exp_().masked_fill_(~ok, 0.0)
    den = sc.sum(-1, keepdim=True).clamp_min_(1e-30)
    out = torch.einsum("bkgst,btkd->bkgsd", sc, v.to(wide)).div_(den)
    return out, m, den, ok


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale=None,
                        return_lse: bool = False):
    """q:(B,S,H,hd) k,v:(B,T,Kh,hd) -> (B,S,H,hd) in q's type: the function
    of the Pallas flash kernel.  Scores in f32 times ``scale`` (hd**-0.5
    unless given: a head dim padded with zeros keeps its own), then the tanh
    softcap, then the causal/window mask; p = exp(s - max) on admitted keys,
    0 elsewhere; out = (p @ v) / max(sum p, 1e-30) in f32 (in f64 for f64
    inputs: the yardstick of the f32 kernel on the card, whose 3xTF32 sums
    lie nearer the exact function than an f32 one does at large head
    dims).  Query head h reads kv head h // (H / Kh).  Materializes the
    (B, H, S, T) scores.
    ``return_lse`` also returns each row's log-sum-exp max + log(max(sum
    p, 1e-30)), (B, Kh, H / Kh, S) f32, with the max taken as 0 for a row
    that admits no key (the reference's ``_flash_fwd_impl`` guard)."""
    b, s, h, hd = q.shape
    out, m, den, ok = _attend_rows(q, k, v, 0, 0, causal=causal,
                                   window=window, softcap=softcap,
                                   scale=scale)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)
    if not return_lse:
        return out
    live = ok.any(-1)[:, None]
    return out, (torch.where(live, m, 0.0) + den.log()).squeeze(-1)


def flash_attention_ref_rows(q, k, v, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0,
                             chunk: int = 1024):
    """:func:`flash_attention_ref`'s output (S = T) computed ``chunk`` query
    rows at a time, each against only the keys its rows can admit, so the
    scores held at once are (B, H, chunk, <= T): the plain version at a
    length whose whole (B, H, S, T) scores do not fit on the card."""
    b, s, h, hd = q.shape
    if k.shape[1] != s:
        raise ValueError(f"{s} query rows against {k.shape[1]} keys")
    out = torch.empty_like(q)
    for q0 in range(0, s, chunk):
        c = min(chunk, s - q0)
        hi = q0 + c if causal else s
        lo = max(0, q0 - window + 1) if window else 0
        rows, *_ = _attend_rows(q[:, q0:q0 + c], k[:, lo:hi], v[:, lo:hi],
                                q0, lo, causal=causal, window=window,
                                softcap=softcap, scale=None)
        out[:, q0:q0 + c] = rows.permute(0, 3, 1, 2, 4).reshape(
            b, c, h, hd).to(q.dtype)
    return out


LOG2E = 1.4426950408889634


# the 16-bit body past hd 256 (flash_wgmma_wide): keys a tile, columns a
# depth box of Q K^T, output columns a block
WIDE_BLOCK_K, WIDE_DEPTH, WIDE_SLICE = 64, 64, 256


def ws_block_k(hd: int) -> int:
    """Keys a tile of the CUDA kernel's ``flash_wgmma_ws`` body at head dim
    ``hd`` (its ``WsTile::BK``): 64 at hd 16 and 32 (two blocks an SM),
    128 at 64 and 80, and 112 at hd 96, where a 128-key tile spills."""
    return 64 if hd < 64 else 112 if hd == 96 else 128


def flash_attention_tiled_ref(q, k, v, *, block_q: int = 128,
                              block_k=None, causal: bool = True,
                              window: int = 0, softcap: float = 0.0,
                              scale=None, return_lse: bool = False):
    """The CUDA kernel's tile walk at head dims 16, 32, 64, 80 and 96
    (``flash_wgmma_ws``) and past 256 (``flash_wgmma_wide``), in bf16 or
    f16, with the arguments and result of :func:`flash_attention_ref`.
    Each tile of ``block_q`` queries walks the live key tiles of
    ``block_k`` keys (:func:`ws_block_k`, past 256 :data:`WIDE_BLOCK_K`,
    unless given) as the kernel's ``live_keys`` computes them: from the
    window's start rounded down to a tile to one past its last query's
    last admitted key.  Past hd 256 each tile's scores are summed in f32
    over depth boxes of :data:`WIDE_DEPTH` columns in order.  The running
    max and sum stay in f32; uncapped, the scale folds into ``exp2``
    (scores and max stay raw); P is summed in f32 and rounded to the input
    type (bf16 or f16) before P V, which at hd 80 and 96 runs as columns
    0-63 and 64-(hd - 1), past 256 as value slices of :data:`WIDE_SLICE`
    columns; the output is the sum times ``1 / l``, rounded once to the
    input type."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    wide = hd > 256
    if block_k is None:
        block_k = WIDE_BLOCK_K if wide else ws_block_k(hd)
    unit = LOG2E if softcap else scale * LOG2E
    qf = q.float().reshape(b, s, kh, h // kh, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]       # (B, Kh, 1, T, hd)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    if wide:
        cols = [(c, min(c + WIDE_SLICE, hd)) for c in range(0, hd, WIDE_SLICE)]
        depth = [(d, min(d + WIDE_DEPTH, hd))
                 for d in range(0, hd, WIDE_DEPTH)]
    else:
        cols = [(0, min(hd, 64))] + ([(64, hd)] if hd > 64 else [])
        depth = [(0, hd)]
    out = torch.empty_like(qf)
    lse = torch.empty(qf.shape[:-1], dtype=torch.float32, device=q.device)
    for q0 in range(0, s, block_q):
        q1 = min(q0 + block_q, s)
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        lo, hi = 0, t
        if causal:
            hi = min(hi, q1)
        if window > 0:
            lo = max(0, q0 - window + 1)
        lo = lo // block_k * block_k
        m = torch.full(qf.shape[:-2] + (q1 - q0,), NEG_INF,
                       dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(m.shape + (hd,), dtype=torch.float32,
                          device=q.device)
        for k0 in range(lo, hi, block_k):
            k1 = min(k0 + block_k, t)
            sc = None
            for d0, d1 in depth:
                box = qf[..., q0:q1, d0:d1] @ kf[..., k0:k1, d0:d1].transpose(
                    -1, -2)
                sc = box if sc is None else sc + box
            if softcap:
                sc = softcap * torch.tanh(sc * (scale / softcap))
            kj = torch.arange(k0, k1, device=q.device)[None, :]
            ok = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                            device=q.device)
            if causal:
                ok &= kj <= qi
            if window:
                ok &= (qi - kj) < window
            sc = sc.masked_fill(~ok, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            corr = torch.exp2((m - m_new) * unit)
            p = torch.exp2(sc * unit - (m_new * unit)[..., None])
            p = p.masked_fill(~ok, 0.0)
            l = l * corr + p.sum(-1)
            p = p.to(q.dtype).float()
            acc = acc * corr[..., None] + torch.cat(
                [p @ vf[..., k0:k1, c0:c1] for c0, c1 in cols], dim=-1)
            m = m_new
        l = l.clamp_min(1e-30)
        out[..., q0:q1, :] = acc * (1.0 / l)[..., None]
        # uncapped, m is in raw score units; a row that admitted no key
        # kept the sentinel
        lse[..., q0:q1] = torch.where(m == NEG_INF, 0.0,
                                      m if softcap else m * scale) + l.log()
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)
    return (out, lse) if return_lse else out


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32 as ``cvt.rna.tf32.f32`` does on its
    bits: the 13 low mantissa bits dropped, to nearest with ties away from
    zero (the magnitude's bits plus 0x1000, then masked), the sign kept.
    Subnormals round on the same bits (the smallest ones to zero, a half
    step up to 2^-136); a finite value past the largest TF32 one by half a
    step or more becomes inf; inf and NaN pass as they are."""
    bits = x.float().contiguous().view(torch.int32)
    mag = bits & 0x7FFFFFFF
    rounded = ((mag + 0x1000) & ~0x1FFF) | (bits & ~0x7FFFFFFF)
    return torch.where(mag < 0x7F800000, rounded, bits).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) cut to TF32 toward zero: its 13 low mantissa bits
    cleared, as the tensor cores read an operand that is not TF32."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(big, small) as the f32 body's tensor cores see them: big =
    tf32(x) (``cvt.rna``), small = x - big (exact) cut to TF32 by the
    tensor cores (:func:`tf32_truncate`): x's value as two TF32 terms, to
    under 2^-21 of x."""
    big = tf32_round(x)
    return big, tf32_truncate(x - big)


def f32_tc_tiles(hd: int) -> tuple:
    """(queries, keys) a tile of the CUDA kernel's f32 body
    (``flash_3xtf32``: ``kBlockQ`` and its ``Tf32Tile::BK``; past 256
    ``flash_3xtf32_wide``'s ``Tf32WideTile::BK``) at head dim ``hd``: 64
    queries (four warps of 16 rows); 32 keys up to hd 96, 16 at 128, 8 at
    256 and 32 past it."""
    return 64, 32 if hd <= 96 or hd > 256 else 16 if hd <= 128 else 8


def _tc_products(a, b, split: bool):
    """a (..., M, K) @ b (..., N, K)^T as the f32 body's tensor cores take
    it, K in 8-deep steps: with ``split`` each step's three TF32 products
    (small.big, big.small, big.big, :func:`split_tf32`) summed from zero in
    f32, else the one product of the TF32-rounded operands; the steps' sums
    added in f32."""
    *lead, m, kd = a.shape
    n = b.shape[-2]
    ac = a.reshape(*lead, m, kd // 8, 8)
    bc = b.reshape(*lead, n, kd // 8, 8)

    def prod(x, y):
        return torch.einsum("...mcd,...ncd->...cmn", x, y)

    if split:
        (ab, asm), (bb, bsm) = split_tf32(ac), split_tf32(bc)
        steps = prod(asm, bb) + prod(ab, bsm) + prod(ab, bb)
    else:
        steps = prod(tf32_round(ac), tf32_round(bc))
    return steps.sum(-3)


def flash_attention_f32_tc_ref(q, k, v, *, causal: bool = True,
                               window: int = 0, softcap: float = 0.0,
                               scale=None, return_lse: bool = False,
                               split: bool = True):
    """The CUDA kernel's f32 body (``flash_3xtf32``) as a tile walk, with
    the arguments and result of :func:`flash_attention_ref` on float32
    inputs whose head dim is a multiple of 8.  Each query tile walks the
    key tiles (:func:`f32_tc_tiles`) from the window's start rounded down
    to a tile (zero-filled past T), as ``live_keys`` does.
    S = Q K^T and each tile's P V take their products on the model of the
    tensor cores (:func:`_tc_products`): 3xTF32, or with ``split=False``
    one TF32 product each (single-pass TF32, which keeps about three
    decimal digits).  The softcap is ``cap * tanh(s * scale / cap)``;
    uncapped, the scores stay raw and the scale folds into exp2's unit.
    The running max and sum stay f32, each tile's P V is added to the f32
    output after its rescale, and the output is the sum over max(l,
    1e-30)."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    if q.dtype != torch.float32 or hd % 8:
        raise ValueError(f"the f32 body takes float32 at a head dim that is "
                         f"a multiple of 8, got {q.dtype} at {hd}")
    scale = hd ** -0.5 if scale is None else scale
    block_q, block_k = f32_tc_tiles(hd)
    unit = LOG2E if softcap else scale * LOG2E
    qf = q.reshape(b, s, kh, h // kh, hd).permute(0, 2, 3, 1, 4)
    pad = -t % block_k
    kf = torch.nn.functional.pad(k.permute(0, 2, 1, 3),
                                 (0, 0, 0, pad))[:, :, None]
    vf = torch.nn.functional.pad(v.permute(0, 2, 1, 3),
                                 (0, 0, 0, pad))[:, :, None]
    out = torch.empty_like(qf)
    lse = torch.empty(qf.shape[:-1], dtype=torch.float32, device=q.device)
    for q0 in range(0, s, block_q):
        q1 = min(q0 + block_q, s)
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        lo, hi = 0, t
        if causal:
            hi = min(hi, q1)
        if window > 0:
            lo = max(0, q0 - window + 1)
        lo = lo // block_k * block_k
        m = torch.full(qf.shape[:-2] + (q1 - q0,), NEG_INF,
                       dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(m.shape + (hd,), dtype=torch.float32,
                          device=q.device)
        for k0 in range(lo, hi, block_k):
            k1 = k0 + block_k
            kt = kf[..., k0:k1, :].expand(-1, -1, h // kh, -1, -1)
            vt = vf[..., k0:k1, :].expand(-1, -1, h // kh, -1, -1)
            sc = _tc_products(qf[..., q0:q1, :], kt, split)
            if softcap:
                sc = softcap * torch.tanh(sc * scale * (1.0 / softcap))
            kj = torch.arange(k0, k1, device=q.device)[None, :]
            ok = kj < t
            if causal:
                ok = ok & (kj <= qi)
            if window:
                ok = ok & ((qi - kj) < window)
            sc = sc.masked_fill(~ok, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            corr = torch.exp2((m - m_new) * unit)
            p = torch.exp2(sc * unit - (m_new * unit)[..., None])
            p = p.masked_fill(~ok, 0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _tc_products(
                p, vt.transpose(-1, -2), split)
            m = m_new
        l = l.clamp_min(1e-30)
        out[..., q0:q1, :] = acc / l[..., None]
        # uncapped, m is in raw score units; a row that admitted no key
        # kept the sentinel
        lse[..., q0:q1] = torch.where(m == NEG_INF, 0.0,
                                      m if softcap else m * scale) + l.log()
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)
    return (out, lse) if return_lse else out


def rwkv6_wkv_ref(r, k, v, logw, u, state):
    """Exact WKV recurrence, token by token.  r, k, logw:(B,S,H,K)
    v:(B,S,H,V) u:(H,K) state:(B,H,K,V) -> (out (B,S,H,V), final state):
    out_t = r_t . (S + diag(u) k_t v_t^T);  S <- diag(exp(logw_t)) S +
    k_t v_t^T.  Types promote op by op as in the reference's oracle (a
    ``lax.scan`` of jnp ops): the state is carried in the promoted type of
    state0, k, v, u and logw, each output in that of r and the state (bf16
    inputs with an f32 state0 give f32 out and state; all bf16, bf16)."""
    carry = state.dtype
    for x in (k, v, logw, u):
        carry = torch.promote_types(carry, x.dtype)
    odt = torch.promote_types(r.dtype, carry)
    state = state.to(carry)
    uu = u[None, :, :, None]
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # (B,H,K,V)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t].to(odt),
                                 (state + uu * kv).to(odt)))
        state = (torch.exp(logw[:, t])[..., None] * state + kv).to(carry)
    return torch.stack(outs, dim=1), state


def _widen(*xs):
    """Each tensor in float32 (the chunked forms' working type)."""
    return tuple(x.float() for x in xs)


def rwkv6_wkv_chunked_ref(r, k, v, logw, u, state, chunk: int = 32):
    """The same function in chunk-parallel form (the reference model's
    ``wkv_chunked``).  Every exponential is of a difference L_a - L_s of
    cumulative log-decays with s <= a, so <= 0: exact, no overflow.
    Materializes the (B, C, C, H, K) in-chunk decay the kernel keeps on
    chip.  A ragged S is padded to a multiple of ``chunk`` with tokens of
    zero r, k, v and log-decay, which leave the state as it is.  Any float
    types: every input is widened to f32, as the reference's Pallas kernel
    widens on load, and the output comes back in r's type (rounded once),
    the state in f32."""
    out_dtype = r.dtype
    r, k, v, logw, u, state = _widen(r, k, v, logw, u, state)
    b, s, h, kk = r.shape
    vv = v.shape[-1]
    pad = -s % chunk
    if pad:
        r, k, v, logw = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                         for x in (r, k, v, logw))
    nc = (s + pad) // chunk
    rs = r.reshape(b, nc, chunk, h, kk)
    ks = k.reshape(b, nc, chunk, h, kk)
    vs = v.reshape(b, nc, chunk, h, vv)
    ws = logw.reshape(b, nc, chunk, h, kk)
    below = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=r.device), -1)[None, :, :, None, None]
    outs = []
    for c in range(nc):
        rc, kc, vc, wc = rs[:, c], ks[:, c], vs[:, c], ws[:, c]
        linc = torch.cumsum(wc, dim=1)            # inclusive cum log decay
        lexc = linc - wc                          # exclusive
        ltot = linc[:, -1:]                       # (B,1,H,K)
        cross = torch.einsum("bthk,bhkv->bthv", rc * torch.exp(lexc), state)
        diff = lexc[:, :, None] - linc[:, None, :, :, :]     # (B,t,s,H,K)
        wdiff = torch.exp(diff.masked_fill(~below, float("-inf")))
        scores = torch.einsum("bthk,bshk,btshk->bhts", rc, kc, wdiff)
        intra = torch.einsum("bhts,bshv->bthv", scores, vc)
        bonus = (rc * u[None, None] * kc).sum(-1)
        outs.append(cross + intra + bonus[..., None] * vc)
        kdec = kc * torch.exp(ltot - linc)
        state = torch.exp(ltot[:, 0])[..., None] * state + \
            torch.einsum("bshk,bshv->bhkv", kdec, vc)
    return torch.cat(outs, dim=1)[:, :s].to(out_dtype), state


def _chunked_decays(logw, chunk: int):
    """Zero-pad the log-decay to whole chunks: (B, nc, C, H, K) inclusive
    cumulative log-decays ``linc`` within each chunk and their totals
    ``ltot`` (B, nc, 1, H, K)."""
    b, s, h, kk = logw.shape
    pad = -s % chunk
    w = torch.nn.functional.pad(logw.float(), (0, 0, 0, 0, 0, pad))
    linc = torch.cumsum(w.reshape(b, -1, chunk, h, kk), dim=2)
    return linc, linc[:, :, -1:]


def _chunks(x, chunk: int):
    b, s, h, d = x.shape
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, -s % chunk))
    return x.reshape(b, -1, chunk, h, d)


def _slices(width: int, tile):
    """(start, stop) of each ``tile``-wide slice of ``width`` (one slice
    without a tile)."""
    tile = tile or width
    return [(a, min(a + tile, width)) for a in range(0, width, tile)]


def wkv_chunk_states_ref(k, v, logw, state0, chunk: int = 32,
                         k_tile=None):
    """Pass 1 of the two-pass WKV (the CUDA kernel's state pass): the only
    sequential part, S <- diag(e^L_{C-1}) S + sum_s (k_s e^(L_{C-1} - L_s))
    v_s^T, chunk by chunk, with no pairwise scores.  k, logw (B,S,H,K),
    v (B,S,H,V), state0 (B,H,K,V), any float types, widened to f32 ->
    (the state at the start of every chunk (B, H, n_chunks, K, V), the
    final state (B,H,K,V)), both f32.  With ``k_tile`` the key rows run
    ``k_tile`` at a time, each slice on its own, as the kernel's grid cuts
    them past K 128 (a key row's recurrence reads only its own column's
    decay and key)."""
    if k_tile is not None and k_tile < k.shape[-1]:
        parts = [wkv_chunk_states_ref(k[..., a:b], v, logw[..., a:b],
                                      state0[:, :, a:b], chunk)
                 for a, b in _slices(k.shape[-1], k_tile)]
        return (torch.cat([x[0] for x in parts], dim=3),
                torch.cat([x[1] for x in parts], dim=2))
    k, v, logw, state0 = _widen(k, v, logw, state0)
    linc, ltot = _chunked_decays(logw, chunk)
    kdec = _chunks(k, chunk) * torch.exp(ltot - linc)       # (B,nc,C,H,K)
    upd = torch.einsum("bcshk,bcshv->bchkv", kdec, _chunks(v, chunk))
    etot = torch.exp(ltot[:, :, 0])[..., None]              # (B,nc,H,K,1)
    starts, state = [], state0
    for c in range(linc.shape[1]):
        starts.append(state)
        state = etot[:, c] * state + upd[:, c]
    return torch.stack(starts, dim=2), state


def wkv_chunk_outputs_ref(r, k, v, logw, u, starts, chunk: int = 32,
                          k_tile=None, v_tile=None):
    """Pass 2 of the two-pass WKV (the CUDA kernel's output pass): every
    chunk at once from its chunk-start state ``starts`` (B, H, n_chunks, K,
    V), out_t = (r_t e^L_{t-1}) S_c + sum_{s<t} score_ts v_s +
    (r_t . (u k_t)) v_t, with the pairwise decay exponentiated per
    (t, s, k) from L_{t-1} - L_s <= 0, in f32 on widened inputs.  -> out
    (B,S,H,V) in r's type, rounded once.  As the kernel cuts a width past
    128: the value columns run ``v_tile`` at a time (each slice forms the
    scores anew), and within a slice the key columns ``k_tile`` at a time,
    each key slice's scores, bonus and cross term added in slice order."""
    out_dtype = r.dtype
    r, k, v, logw, u, starts = _widen(r, k, v, logw, u, starts)
    s = r.shape[1]
    linc, _ = _chunked_decays(logw, chunk)
    lexc = linc - _chunks(logw.float(), chunk)
    rc, kc, vc = (_chunks(x, chunk) for x in (r, k, v))
    below = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=r.device), -1)[:, :, None, None]
    outs = []
    for v0, v1 in _slices(v.shape[-1], v_tile):
        cross = scores = bonus = 0.0
        for k0, k1 in _slices(k.shape[-1], k_tile):
            rk, kk_, lin, lex = (x[..., k0:k1] for x in (rc, kc, linc, lexc))
            cross = cross + torch.einsum("bcthk,bhckv->bcthv",
                                         rk * torch.exp(lex),
                                         starts[:, :, :, k0:k1, v0:v1])
            diff = lex[:, :, :, None] - lin[:, :, None]     # (B,nc,t,s,H,K)
            wdiff = torch.exp(diff.masked_fill(~below, float("-inf")))
            scores = scores + torch.einsum("bcthk,bcshk,bctshk->bchts", rk,
                                           kk_, wdiff)
            bonus = bonus + (rk * u[None, None, None, :, k0:k1] * kk_).sum(
                -1, keepdim=True)
        vs = vc[..., v0:v1]
        intra = torch.einsum("bchts,bcshv->bcthv", scores, vs)
        outs.append(cross + intra + bonus * vs)
    out = torch.cat(outs, dim=-1)
    return out.reshape(r.shape[0], -1, *out.shape[3:])[:, :s].to(out_dtype)


def rwkv6_wkv_two_pass_ref(r, k, v, logw, u, state0, chunk: int = 32,
                           k_tile=None, v_tile=None):
    """The WKV split as the CUDA kernel splits it: the chunk-start states
    by :func:`wkv_chunk_states_ref`, then every chunk's outputs from them
    by :func:`wkv_chunk_outputs_ref`, with the kernel's key and value
    slices where given (``rwkv6_wkv.tile_width`` of the padded widths).
    Same arguments and result as :func:`rwkv6_wkv_chunked_ref` (out in r's
    type, the state in f32); ragged S is padded with zero tokens."""
    starts, state = wkv_chunk_states_ref(k, v, logw, state0, chunk, k_tile)
    return wkv_chunk_outputs_ref(r, k, v, logw, u, starts, chunk, k_tile,
                                 v_tile), state
