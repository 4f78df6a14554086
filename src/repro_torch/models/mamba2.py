"""Mamba-2 (SSD) block, the port of ``repro/models/mamba2.py``: the mamba
layers of the zamba2 hybrid.

Chunked SSD: per-head *scalar* log-decay means the in-chunk pairwise decay
is a plain (C, C) matrix per head, exact and overflow-safe below the
diagonal (every exponent there is a non-positive difference of a running
cumulative sum); above it the exponent is positive and may overflow, and
``torch.where`` drops it (a multiply by the mask would turn inf into NaN).
``ssd_recurrent`` is the decode path and the oracle.  Both are plain
PyTorch, as the reference computes them in jnp outside any kernel.
State = conv tail (B, k-1, conv_ch) + SSD state (B, H, P, N): constant in
sequence length.

Parameters keep the reference's layout.  Where the reference combines a
bf16 parameter (``A_log``, ``dt_bias``, ``D`` after ``cast_params``) with an
f32 activation or state (JAX promotes to f32), the port takes the
parameter to f32 itself.

Over a model axis whose plan cuts the heads (``sharding/tp.py::Plan.
ssm_heads``) each member holds its heads' ``z``/``x``/``dt`` columns of
``in_proj`` and the whole ``B``/``C`` ones (``ngroups`` is 1: every head
reads them; ``partition.Segments`` lays them out), its ``x`` conv channels
beside the ``B``/``C`` ones, its heads of ``A_log``, ``dt_bias``, ``D``,
``gate_norm`` and the SSD state, and its rows of the row-parallel
``out_proj``, which leaves through ``reduce_from``.  The whole ``B``/``C``
columns enter through ``copy_to_slice``, so their gradient is summed over
the members.  ``gate_norm`` normalises over the whole ``d_inner``: its
sum of squares is summed over the members by ``sum_shared`` (a B·S f32
vector a layer), whose backward sums too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.sharding import tp as TP


def dims(cfg: ModelConfig):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    n_heads = d_inner // ssm.head_dim
    conv_ch = d_inner + 2 * ssm.d_state
    return d_inner, n_heads, conv_ch


def member_dims(cfg: ModelConfig, tp=None):
    """:func:`dims` of this member's share under ``tp`` (its heads' inner
    width and heads, its conv channels), and the model group (None where
    the heads run whole)."""
    d_inner, nh, _ = dims(cfg)
    if tp is None or not tp.ssm_heads:
        return d_inner, nh, d_inner + 2 * cfg.ssm.d_state, None
    d_inner, nh = d_inner // tp.n, nh // tp.n
    return d_inner, nh, d_inner + 2 * cfg.ssm.d_state, tp.group


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def mamba2_specs(cfg: ModelConfig):
    return {
        "norm": L.rmsnorm_specs(),
        "in_proj": L.dense_specs("embed", "heads"),
        "conv_w": (None, "heads"),
        "conv_b": ("heads",),
        "A_log": ("heads",),
        "dt_bias": ("heads",),
        "D": ("heads",),
        "gate_norm": {"scale": ("heads",)},
        "out_proj": L.dense_specs("heads", "embed"),
    }


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, device):
    """One layer's leaves in ``cfg.dtype``, with the reference's
    distributions (each drawn in f32 and cast)."""
    ssm, dt = cfg.ssm, cfg.dtype
    cdt = L.dtype_of(dt)
    d_inner, nh, conv_ch = dims(cfg)
    d_in_proj = 2 * d_inner + 2 * ssm.d_state + nh

    def full(shape, value):
        return torch.full(shape, value, dtype=cdt, device=device)

    return {
        "norm": L.init_rmsnorm(cfg.d_model, dt, device),
        "in_proj": L.init_dense(gen, cfg.d_model, d_in_proj, dt, device),
        "conv_w": L.truncated_normal(gen, (ssm.d_conv, conv_ch),
                                     ssm.d_conv ** -0.5, cdt, device),
        "conv_b": full((conv_ch,), 0.0),
        "A_log": full((nh,), 0.0),          # A = -exp(A_log) = -1
        "dt_bias": full((nh,), -2.0),
        "D": full((nh,), 1.0),
        "gate_norm": L.init_rmsnorm(d_inner, dt, device),
        "out_proj": L.init_dense(gen, d_inner, cfg.d_model, dt, device,
                                 scale=d_inner ** -0.5),
    }


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------


def conv_full(w, b, x):
    """x:(B,S,C); causal depthwise conv, kernel k=w.shape[0]: the taps
    j = 0..k-1 summed in the reference's order, then the bias."""
    k, s = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for j in range(k):
        shift = k - 1 - j
        xs = F.pad(x, (0, 0, shift, 0))[:, :s]
        out = out + w[j] * xs
    return out + b


def conv_step(w, b, conv_state, xt):
    """xt:(B,1,C); conv_state:(B,k-1,C) holding the previous inputs ->
    (out (B,1,C), the new conv state)."""
    window = torch.cat([conv_state, xt], dim=1)          # (B,k,C)
    out = torch.einsum("kc,bkc->bc", w, window)[:, None] + b
    return out, window[:, 1:]


# ---------------------------------------------------------------------------
# SSD evaluators
# ---------------------------------------------------------------------------


def ssd_recurrent(x, dt, A_log, B, C, D, state):
    """x:(B,S,H,P) dt:(B,S,H) B,C:(B,S,N) state:(B,H,P,N), f32 -> (y
    (B,S,H,P), final state), token by token."""
    rate = torch.exp(A_log).float()                      # -A, (H,)
    ys = []
    for t in range(x.shape[1]):
        dtt = dt[:, t]
        a = torch.exp(-rate * dtt)                       # (B,H)
        xbar = x[:, t] * dtt[..., None]
        state = a[..., None, None] * state + \
            xbar[..., None] * B[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", state, C[:, t]))
    y = torch.stack(ys, dim=1) + D.float()[None, None, :, None] * x
    return y, state


def ssd_chunked(x, dt, A_log, B, C, D, state, chunk: int = 128):
    """Chunk-parallel SSD; shapes as :func:`ssd_recurrent`, S % chunk ==
    0.  The chunks run one after another in a Python loop (the reference's
    ``lax.scan``); its ``jax.checkpoint`` of the chunk body has no
    counterpart here (the layer as a whole runs under ``cfg.remat``).  The
    in-chunk decay's exponent is -inf above the diagonal before the
    ``exp`` (exp gives the 0 the mask asks for): the difference taken there
    can overflow, and a dropped inf would make the gradient 0 * inf = NaN
    (the reference masks only the result and has that fault); below it
    the values are the same."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    a = -torch.exp(A_log).float()[None, None] * dt       # (B,S,H) log decay
    xbar = x * dt[..., None]
    xc, ac = xbar.reshape(b, nc, chunk, h, p), a.reshape(b, nc, chunk, h)
    bc, cc = B.reshape(b, nc, chunk, n), C.reshape(b, nc, chunk, n)
    xorig = x.reshape(b, nc, chunk, h, p)
    d = D.float()[None, None, :, None]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    ys = []
    for c in range(nc):
        xk, ak, bk, ck, xo = (xc[:, c], ac[:, c], bc[:, c], cc[:, c],
                              xorig[:, c])
        la = torch.cumsum(ak, dim=1)                     # (B,C,H) inclusive
        ltot = la[:, -1:]                                # (B,1,H)
        # intra: scores[t,s] = (C_t . B_s) * exp(la_t - la_s), s <= t
        cb = torch.einsum("btn,bsn->bts", ck, bk)
        dec = torch.exp(torch.where(mask, la[:, :, None] - la[:, None],
                                    float("-inf")))      # (B,t,s,H)
        scores = cb[..., None] * dec
        intra = torch.einsum("btsh,bshp->bthp", scores, xk)
        cross = torch.einsum("btn,bhpn->bthp", ck, state) * \
            torch.exp(la)[..., None]
        ys.append(intra + cross + d * xo)
        # state update
        bw = bk[:, :, None, :] * torch.exp(ltot - la)[..., None]  # (B,C,H,N)
        state = torch.exp(ltot[:, 0])[..., None, None] * state + \
            torch.einsum("bshn,bshp->bhpn", bw, xk)
    return torch.stack(ys, dim=1).reshape(b, s, h, p), state


# ---------------------------------------------------------------------------
# block
# ---------------------------------------------------------------------------


def _gate_norm(p, y, cfg: ModelConfig, group):
    """RMSNorm over the whole ``d_inner`` (f32 inside, as
    ``layers.rmsnorm``), each member holding its channels under ``group``:
    the sum of squares summed over the members (``sum_shared``; the
    identity without a group)."""
    yf = y.float()
    d_inner, _, _ = dims(cfg)
    ss = TP.sum_shared(yf.square().sum(-1, keepdim=True), group)
    return (yf * torch.rsqrt(ss / d_inner + cfg.norm_eps)
            * p["scale"].float()).to(y.dtype)


def block(p, cfg: ModelConfig, x, state=None, chunked: bool = True, *,
          tp=None):
    """x:(B,S,D).  state: None (a full sequence) or dict(conv (B,k-1,C),
    ssd (B,H,P,N)) -> (x + out, new state: "ssd", and "conv" when a state
    was given).  The chunked evaluator runs only when ``chunked`` and S is
    a whole number (> 1) of chunks, as in the reference; any other length
    runs the token-by-token scan.  Under ``tp`` cutting the heads, H and C
    are this member's (the module docstring)."""
    ssm = cfg.ssm
    d_inner, nh, _, group = member_dims(cfg, tp)
    b, s, _ = x.shape
    h = TP.copy_to(L.rmsnorm(p["norm"], x, cfg.norm_eps), group)
    w_in = TP.copy_to_slice(p["in_proj"]["kernel"], group, 2 * d_inner,
                            2 * ssm.d_state)
    z, xbc, dt = torch.split(L.dense(dict(p["in_proj"], kernel=w_in), h),
                             [d_inner, d_inner + 2 * ssm.d_state, nh],
                             dim=-1)
    new_state = {}
    w, bias = (TP.copy_to_slice(p[k], group, d_inner, 2 * ssm.d_state)
               .to(xbc.dtype) for k in ("conv_w", "conv_b"))
    if state is None:
        xbc = conv_full(w, bias, xbc)
    else:
        xbc, new_state["conv"] = conv_step(w, bias, state["conv"], xbc)
    xbc = F.silu(xbc)
    xs, B, C = torch.split(xbc, [d_inner, ssm.d_state, ssm.d_state], dim=-1)
    xs = xs.reshape(b, s, nh, ssm.head_dim)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    ssd_state = (state or {}).get("ssd")
    if ssd_state is None:
        ssd_state = torch.zeros((b, nh, ssm.head_dim, ssm.d_state),
                                dtype=torch.float32, device=x.device)
    args = (xs.float(), dt, p["A_log"], B.float(), C.float(), p["D"],
            ssd_state)
    if chunked and s % ssm.chunk == 0 and s > 1:
        y, new_state["ssd"] = ssd_chunked(*args, chunk=ssm.chunk)
    else:
        y, new_state["ssd"] = ssd_recurrent(*args)
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = _gate_norm(p["gate_norm"], y * F.silu(z), cfg, group)
    return x + TP.reduce_from(L.dense(p["out_proj"], y), group), new_state


def make_state(cfg: ModelConfig, batch: int, dtype=None, device="cuda"):
    """Zero state of one layer: conv (B, k-1, conv_ch) in ``dtype`` (the
    config's by default), ssd (B, H, P, N) in f32."""
    device = resolve_device(device)
    ssm = cfg.ssm
    _, nh, conv_ch = dims(cfg)
    dt = L.dtype_of(dtype or cfg.dtype)
    return {
        "conv": torch.zeros((batch, ssm.d_conv - 1, conv_ch), dtype=dt,
                            device=device),
        "ssd": torch.zeros((batch, nh, ssm.head_dim, ssm.d_state),
                           dtype=torch.float32, device=device),
    }
