"""Plain-PyTorch versions of the hand-written kernels (the port of
``repro/kernels/ref.py``).  The kernel wrappers take these for CPU tensors,
the tests hold the port against the reference with them, and
``chip_smoke.py`` compares every kernel with them on the card.

The WKV has two: the exact recurrence (the oracle, and the model's decode
path) and the chunked form (the CUDA kernel's plain version).  The bag, the
interaction and the WKV kernels also have a CPU model of the order in which
each kernel sums (``embedding_bag_split_ref``, ``dot_interaction_split_ref``,
``rwkv6_wkv_two_pass_ref``), and the flash kernel's hd 64/80 body one of its
tile walk (``flash_attention_tiled_ref``), held against the reference by
the tests.

Ids are clamped to ``[0, R-1]`` (and table ids to ``[0, T-1]``) explicitly:
JAX clamps out-of-bounds gathers silently, torch indexing raises.
"""
from __future__ import annotations

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
    ...).  S must be a multiple of 4."""
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


def _clamped(idx: torch.Tensor, n: int) -> torch.Tensor:
    return idx.long().clamp(0, n - 1)


def embedding_bag_ref(table, idx, mask):
    """table:(R,S) idx:(B,hot) mask:(B,hot) -> (B,S) masked-sum bags."""
    rows = table[_clamped(idx, table.shape[0])]             # (B,hot,S)
    return (rows * mask[..., None].to(rows.dtype)).sum(1)


def embedding_bag_stacked_ref(tables, idx, mask):
    """tables:(T,R,S) idx/mask:(B,T,hot) -> (B,T,S) per-table masked sums.
    Materializes the (B,T,hot,S) gather the kernel avoids."""
    t, r, _ = tables.shape
    tab = torch.arange(t, device=tables.device)[None, :, None]
    rows = tables[tab, _clamped(idx, r)]                      # (B,T,hot,S)
    return (rows * mask[..., None].to(rows.dtype)).sum(2)


def embedding_bag_rows_ref(tables, tid, idx, mask):
    """tables:(T,R,S) tid:(N,) idx/mask:(N,hot) -> (N,S) masked sums, each
    row pooled against its own table."""
    t, r, _ = tables.shape
    rows = tables[_clamped(tid, t)[:, None], _clamped(idx, r)]
    return (rows * mask[..., None].to(rows.dtype)).sum(1)


def embedding_bag_split_ref(table_flat, idx, w, *, rows: int, n_tables: int,
                            tid=None, groups: int = 1):
    """CPU model of the CUDA bag kernel's summation order, over the flat
    (n_tables * rows, s) row space as the kernel sees it: bag n pools
    against table clamp(tid[n]) (or n % n_tables without tid); its slots
    are split over ``groups`` groups, group k adding the rounded products
    of slots k, k + groups, ... in order to a sum that starts at 0, and the
    group sums are added in order 0, 1, ....  Bit-exact to the kernel with
    the same ``groups`` (``embedding_bag.launch_plan`` reads the kernel's)."""
    n, hot = idx.shape
    if tid is None:
        t = torch.arange(n, device=idx.device) % n_tables
    else:
        t = _clamped(tid, n_tables)
    x = table_flat[t[:, None] * rows + _clamped(idx, rows)] \
        * w[..., None].to(table_flat.dtype)                   # (N, hot, s)
    out = None
    for k in range(groups):
        acc = torch.zeros((n, table_flat.shape[1]), dtype=table_flat.dtype,
                          device=table_flat.device)
        for h in range(k, hot, groups):
            acc = acc + x[:, h]
        out = acc if out is None else out + acc
    return out


# the Pallas kernel's finite mask sentinel (flash_attention.py:22)
NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale=None,
                        return_lse: bool = False):
    """q:(B,S,H,hd) k,v:(B,T,Kh,hd) -> (B,S,H,hd) in q's type: the function
    of the Pallas flash kernel.  Scores in f32 times ``scale`` (hd**-0.5
    unless given: a head dim padded with zeros keeps its own), then the tanh
    softcap, then the causal/window mask; p = exp(s - max) on admitted keys,
    0 elsewhere; out = (p @ v) / max(sum p, 1e-30) in f32.  Query head h
    reads kv head h // (H / Kh).  Materializes the (B, H, S, T) scores.
    ``return_lse`` also returns each row's log-sum-exp max + log(max(sum
    p, 1e-30)), (B, Kh, H / Kh, S) f32, with the max taken as 0 for a row
    that admits no key (the reference's ``_flash_fwd_impl`` guard)."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, s, kh, h // kh, hd)
    sc = torch.einsum("bskgd,btkd->bkgst", qf, k.float()).mul_(
        hd ** -0.5 if scale is None else scale)
    if softcap:
        sc.div_(softcap).tanh_().mul_(softcap)
    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(t, device=q.device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kj <= qi
    if window:
        ok &= (qi - kj) < window
    sc.masked_fill_(~ok, NEG_INF)
    m = sc.amax(-1, keepdim=True)
    sc.sub_(m).exp_().masked_fill_(~ok, 0.0)
    den = sc.sum(-1, keepdim=True).clamp_min_(1e-30)
    out = torch.einsum("bkgst,btkd->bkgsd", sc, v.float()).div_(den)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)
    if not return_lse:
        return out
    live = ok.any(-1)[:, None]
    return out, (torch.where(live, m, 0.0) + den.log()).squeeze(-1)


LOG2E = 1.4426950408889634


def flash_attention_tiled_ref(q, k, v, *, block_q: int = 128,
                              block_k: int = 128, causal: bool = True,
                              window: int = 0, softcap: float = 0.0,
                              scale=None, return_lse: bool = False):
    """The CUDA kernel's tile walk at head dims 64 and 80
    (``flash_wgmma_ws``), with the arguments and result of
    :func:`flash_attention_ref`.  Each tile of ``block_q`` queries walks the
    live key tiles as the kernel's ``live_keys`` computes them: from the
    window's start rounded down to a tile to one past its last query's
    last admitted key.  The running max and sum stay in f32; uncapped, the
    scale folds into ``exp2`` (scores and max stay raw); P is summed in f32
    and rounded to the input type before P V, which at hd 80 runs as
    columns 0-63 and 64-79; the output is the sum times ``1 / l``."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    unit = LOG2E if softcap else scale * LOG2E
    qf = q.float().reshape(b, s, kh, h // kh, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]       # (B, Kh, 1, T, hd)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    cols = [(0, min(hd, 64))] + ([(64, hd)] if hd > 64 else [])
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
            sc = qf[..., q0:q1, :] @ kf[..., k0:k1, :].transpose(-1, -2)
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


def rwkv6_wkv_ref(r, k, v, logw, u, state):
    """Exact WKV recurrence, token by token.  r, k, logw:(B,S,H,K)
    v:(B,S,H,V) u:(H,K) state:(B,H,K,V) -> (out (B,S,H,V), final state):
    out_t = r_t . (S + diag(u) k_t v_t^T);  S <- diag(exp(logw_t)) S +
    k_t v_t^T."""
    uu = u[None, :, :, None]
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # (B,H,K,V)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], state + uu * kv))
        state = torch.exp(logw[:, t])[..., None] * state + kv
    return torch.stack(outs, dim=1), state


def rwkv6_wkv_chunked_ref(r, k, v, logw, u, state, chunk: int = 32):
    """The same function in chunk-parallel form (the reference model's
    ``wkv_chunked``).  Every exponential is of a difference L_a - L_s of
    cumulative log-decays with s <= a, so <= 0: exact, no overflow.
    Materializes the (B, C, C, H, K) in-chunk decay the kernel keeps on
    chip.  A ragged S is padded to a multiple of ``chunk`` with tokens of
    zero r, k, v and log-decay, which leave the state as it is."""
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
    ws = logw.reshape(b, nc, chunk, h, kk).float()
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
    return torch.cat(outs, dim=1)[:, :s], state


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


def wkv_chunk_states_ref(k, v, logw, state0, chunk: int = 32):
    """Pass 1 of the two-pass WKV (the CUDA kernel's state pass): the only
    sequential part, S <- diag(e^L_{C-1}) S + sum_s (k_s e^(L_{C-1} - L_s))
    v_s^T, chunk by chunk, with no pairwise scores.  k, logw (B,S,H,K),
    v (B,S,H,V), state0 (B,H,K,V) -> (the state at the start of every
    chunk (B, H, n_chunks, K, V), the final state (B,H,K,V))."""
    linc, ltot = _chunked_decays(logw, chunk)
    kdec = _chunks(k, chunk) * torch.exp(ltot - linc)       # (B,nc,C,H,K)
    upd = torch.einsum("bcshk,bcshv->bchkv", kdec, _chunks(v, chunk))
    etot = torch.exp(ltot[:, :, 0])[..., None]              # (B,nc,H,K,1)
    starts, state = [], state0
    for c in range(linc.shape[1]):
        starts.append(state)
        state = etot[:, c] * state + upd[:, c]
    return torch.stack(starts, dim=2), state


def wkv_chunk_outputs_ref(r, k, v, logw, u, starts, chunk: int = 32):
    """Pass 2 of the two-pass WKV (the CUDA kernel's output pass): every
    chunk at once from its chunk-start state ``starts`` (B, H, n_chunks, K,
    V), out_t = (r_t e^L_{t-1}) S_c + sum_{s<t} score_ts v_s +
    (r_t . (u k_t)) v_t, with the pairwise decay exponentiated per
    (t, s, k) from L_{t-1} - L_s <= 0.  -> out (B,S,H,V)."""
    s = r.shape[1]
    linc, _ = _chunked_decays(logw, chunk)
    lexc = linc - _chunks(logw.float(), chunk)
    rc, kc, vc = (_chunks(x, chunk) for x in (r, k, v))
    cross = torch.einsum("bcthk,bhckv->bcthv", rc * torch.exp(lexc), starts)
    below = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=r.device), -1)[:, :, None, None]
    diff = lexc[:, :, :, None] - linc[:, :, None]           # (B,nc,t,s,H,K)
    wdiff = torch.exp(diff.masked_fill(~below, float("-inf")))
    scores = torch.einsum("bcthk,bcshk,bctshk->bchts", rc, kc, wdiff)
    intra = torch.einsum("bchts,bcshv->bcthv", scores, vc)
    bonus = (rc * u[None, None, None] * kc).sum(-1, keepdim=True)
    out = cross + intra + bonus * vc
    return out.reshape(r.shape[0], -1, *out.shape[3:])[:, :s]


def rwkv6_wkv_two_pass_ref(r, k, v, logw, u, state0, chunk: int = 32):
    """The WKV split as the CUDA kernel splits it: the chunk-start states
    by :func:`wkv_chunk_states_ref`, then every chunk's outputs from them
    by :func:`wkv_chunk_outputs_ref`.  Same arguments and result as
    :func:`rwkv6_wkv_chunked_ref`; ragged S is padded with zero tokens."""
    starts, state = wkv_chunk_states_ref(k, v, logw, state0, chunk)
    return wkv_chunk_outputs_ref(r, k, v, logw, u, starts, chunk), state
