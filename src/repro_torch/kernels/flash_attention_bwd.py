"""The backward pass of flash attention in plain PyTorch: the port of the
reference's ``_flash_vjp_bwd`` (``repro/models/attention.py:188-280``),
which is jnp, not a Pallas kernel, so this is not a kernel either.

From the forward's residuals (q, k, v, out and each row's log-sum-exp) it
recomputes the probabilities chunk by chunk and never holds the whole
(S, T) score matrix:

- delta_i = sum_d dout_i . out_i per query row;
- p = exp(s - lse) on admitted keys (0 elsewhere), s the scaled and
  softcapped scores in f32;
- ds = p (dp - delta) (1 - tanh^2(s_pre / cap) with a softcap) * scale,
  dp = dout . v in f32;
- pass 1, over query chunks: dq accumulates ds @ k in f32 over the key
  chunks, ds taken to k's type first, as the reference does;
- pass 2, over key chunks: dv accumulates p^T dout and dk ds^T q in f32
  over the query chunks.

Chunk pairs that admit no (query, key) pair (above the causal diagonal,
beyond the window) are skipped: their terms are exact zeros.  Results come
back in the inputs' types.
"""
from __future__ import annotations

import torch

# the reference model's flash tiles (attend_full: min(1024, S) for both)
CHUNK = 1024


def _live(q0: int, q1: int, k0: int, k1: int, causal: bool,
          window: int) -> bool:
    """Whether query rows [q0, q1) admit any key of [k0, k1)."""
    if causal and k0 > q1 - 1:
        return False
    return not (window and q0 - (k1 - 1) >= window)


def _probs(qc, kc, lse_c, q0, k0, *, causal, window, softcap, scale):
    """(B,cq,Kh,G,hd), (B,ck,Kh,hd) -> p (B,Kh,G,cq,ck) f32 and the
    pre-softcap scores."""
    sc_pre = torch.einsum("bqkgd,bskd->bkgqs", qc.float(), kc.float()) \
        * scale
    sc = softcap * torch.tanh(sc_pre / softcap) if softcap else sc_pre
    qi = torch.arange(q0, q0 + qc.shape[1], device=qc.device)[:, None]
    kj = torch.arange(k0, k0 + kc.shape[1], device=qc.device)[None, :]
    ok = torch.ones((qc.shape[1], kc.shape[1]), dtype=torch.bool,
                    device=qc.device)
    if causal:
        ok &= kj <= qi
    if window:
        ok &= (qi - kj) < window
    p = torch.exp(sc - lse_c[..., None]).masked_fill_(~ok, 0.0)
    return p, sc_pre


def _ds(p, dp, delta_c, sc_pre, softcap, scale):
    ds = p * (dp - delta_c[..., None])
    if softcap:
        ds = ds * (1.0 - torch.tanh(sc_pre / softcap).square())
    return ds * scale


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        chunk: int = CHUNK):
    """q, out, dout (B,S,H,hd), k, v (B,T,Kh,hd), lse (B,Kh,H/Kh,S) f32 ->
    (dq, dk, dv) in q's, k's and v's types, at the scale hd ** -0.5 (the
    unpadded head dim's); ``chunk`` is the query and key tile."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = hd ** -0.5
    kw = {"causal": causal, "window": window, "softcap": softcap,
          "scale": scale}
    qg = q.reshape(b, s, kh, g, hd)
    dog = dout.reshape(b, s, kh, g, hd).float()
    delta = (dog * out.reshape(b, s, kh, g, hd).float()).sum(-1) \
        .permute(0, 2, 3, 1)                               # (B,Kh,G,S)
    q_tiles = [(q0, min(q0 + chunk, s)) for q0 in range(0, s, chunk)]
    k_tiles = [(k0, min(k0 + chunk, t)) for k0 in range(0, t, chunk)]

    dq = torch.empty((b, s, kh, g, hd), dtype=q.dtype, device=q.device)
    for q0, q1 in q_tiles:
        qc, do_c = qg[:, q0:q1], dog[:, q0:q1]
        lse_c, delta_c = lse[..., q0:q1], delta[..., q0:q1]
        acc = torch.zeros((b, q1 - q0, kh, g, hd), dtype=torch.float32,
                          device=q.device)
        for k0, k1 in k_tiles:
            if not _live(q0, q1, k0, k1, causal, window):
                continue
            kc, vc = k[:, k0:k1], v[:, k0:k1]
            p, sc_pre = _probs(qc, kc, lse_c, q0, k0, **kw)
            dp = torch.einsum("bqkgd,bskd->bkgqs", do_c, vc.float())
            ds = _ds(p, dp, delta_c, sc_pre, softcap, scale)
            acc += torch.einsum("bkgqs,bskd->bqkgd", ds.to(k.dtype),
                                kc).float()
        dq[:, q0:q1] = acc

    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for k0, k1 in k_tiles:
        kc, vc = k[:, k0:k1], v[:, k0:k1]
        dk_acc = torch.zeros((b, k1 - k0, kh, hd), dtype=torch.float32,
                             device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for q0, q1 in q_tiles:
            if not _live(q0, q1, k0, k1, causal, window):
                continue
            qc, do_c = qg[:, q0:q1], dog[:, q0:q1]
            p, sc_pre = _probs(qc, kc, lse[..., q0:q1], q0, k0, **kw)
            dv_acc += torch.einsum("bkgqs,bqkgd->bskd", p, do_c)
            dp = torch.einsum("bqkgd,bskd->bkgqs", do_c, vc.float())
            ds = _ds(p, dp, delta[..., q0:q1], sc_pre, softcap, scale)
            dk_acc += torch.einsum("bkgqs,bqkgd->bskd", ds, qc.float())
        dk[:, k0:k1] = dk_acc
        dv[:, k0:k1] = dv_acc
    return dq.reshape(b, s, h, hd), dk, dv
