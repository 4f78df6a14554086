"""RWKV-6 "Finch" (arXiv:2404.05892), the port of ``repro/models/rwkv6.py``:
attention-free, data-dependent decay.

Two WKV evaluators, as in the reference:
  * ``wkv_recurrent``: the exact token-by-token recurrence (decode, ragged
    S, and the oracle);
  * ``wkv_chunked``: the chunk-parallel form, the plain version of the CUDA
    kernel that :func:`time_mix` reaches through ``ops.rwkv6_wkv_op``.

Parameters keep the reference's layout, every per-layer leaf stacked on a
leading ``n_layers`` axis as its ``vmap`` init lays them out, so
``transformer.params_from_jax`` converts them with a plain copy.
:func:`init_rwkv6` draws each leaf in f32 and casts it to ``cfg.dtype``
(the bits the reference's apply-time ``cast_params`` of its f32 masters
gives); ``cast_params`` still runs at apply time and is a no-op on such
parameters.  Where the reference multiplies an f32 activation by a bf16
weight (JAX promotes to f32), the port takes the weight to f32 itself.

State per layer = two token-shift vectors (B,1,D) + WKV state (B,H,K,V).

Over a model axis (``sharding/tp.py::plan``) each member runs its
H / n heads of the time mix and its d_ff / n columns of the channel mix.
The ddlerp and the decay LoRA's first product stay replicated; the five
mixes enter the column-parallel ``wr``/``wk``/``wv``/``wg`` through
``copy_to``, ``time_faaaa`` and the WKV state are cut by heads, and each
member takes its heads' columns of the whole "embed" leaves
``time_decay``, ``decay_B`` and ``ln_x`` (each through ``copy_to``, so
its gradient is summed over the members); the per-head group norm is
local; ``wo`` is row-parallel and leaves through ``reduce_from``.  The
channel mix's ``cm_k`` is column-parallel and ``cm_v`` row-parallel;
``cm_r`` stays whole (its output gates the reduced ``cm_v`` output).
Where the heads or the width do not divide, that part runs replicated.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import tp as TP

HEAD_SIZE = 64
LORA_MAA = 32
LORA_DECAY = 64
CHUNK = 32          # the reference's chunk: whole chunks take the kernel op

# the two evaluators are the plain versions in kernels/ref.py
wkv_recurrent = ref.rwkv6_wkv_ref
wkv_chunked = ref.rwkv6_wkv_chunked_ref


def n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // HEAD_SIZE


def _member(tp, cut: bool):
    """(group, members, this member) of a part cut over the model axis, or
    (None, 1, 0) where it runs whole."""
    return (tp.group, tp.n, tp.m) if tp is not None and cut else \
        (None, 1, 0)


def _cols(leaf, group, cols):
    """This member's columns of a whole leaf used inside a cut region
    (its gradient summed over ``group``)."""
    return TP.copy_to(leaf, group)[..., cols]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(gen, cfg: ModelConfig, dev):
    """One layer's leaves, each drawn in f32 and cast to ``cfg.dtype``."""
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    cdt = L.dtype_of(dt)

    def tn(shape, scale):
        return L.truncated_normal(gen, shape, scale, cdt, dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=cdt, device=dev)

    return {
        "ln1": L.init_layernorm(d, dt, dev),
        "ln2": L.init_layernorm(d, dt, dev),
        "maa_x": zeros(d),
        "maa_rkvwg": zeros(5, d),
        "maa_A": tn((d, 5 * LORA_MAA), d ** -0.5),
        "maa_B": tn((5, LORA_MAA, d), LORA_MAA ** -0.5),
        "time_decay": zeros(d),
        "decay_A": tn((d, LORA_DECAY), d ** -0.5),
        "decay_B": tn((LORA_DECAY, d), LORA_DECAY ** -0.5),
        "time_faaaa": tn((n_heads(cfg), HEAD_SIZE), 0.5),
        "wr": L.init_dense(gen, d, d, dt, dev),
        "wk": L.init_dense(gen, d, d, dt, dev),
        "wv": L.init_dense(gen, d, d, dt, dev),
        "wg": L.init_dense(gen, d, d, dt, dev),
        "wo": L.init_dense(gen, d, d, dt, dev, scale=d ** -0.5),
        "ln_x": L.init_layernorm(d, dt, dev),
        "cm_maa_k": zeros(d),
        "cm_maa_r": zeros(d),
        "cm_k": L.init_dense(gen, d, f, dt, dev),
        "cm_v": L.init_dense(gen, f, d, dt, dev, scale=f ** -0.5),
        "cm_r": L.init_dense(gen, d, d, dt, dev),
    }


def _layer_specs(cfg: ModelConfig):
    dd = L.dense_specs("embed", "heads")
    return {
        "ln1": L.layernorm_specs(), "ln2": L.layernorm_specs(),
        "maa_x": ("embed",), "maa_rkvwg": (None, "embed"),
        "maa_A": ("embed", None), "maa_B": (None, None, "embed"),
        "time_decay": ("embed",), "decay_A": ("embed", None),
        "decay_B": (None, "embed"), "time_faaaa": ("heads", None),
        "wr": dd, "wk": dd, "wv": dd, "wg": dd,
        "wo": L.dense_specs("heads", "embed"),
        "ln_x": L.layernorm_specs(),
        "cm_maa_k": ("embed",), "cm_maa_r": ("embed",),
        "cm_k": L.dense_specs("embed", "mlp"),
        "cm_v": L.dense_specs("mlp", "embed"),
        "cm_r": L.dense_specs("embed", "heads"),
    }


def rwkv6_specs(cfg: ModelConfig):
    return {
        "embed": L.embedding_specs(),
        "ln0": L.layernorm_specs(),
        "layers": L.stack_specs(_layer_specs(cfg), "layers"),
        "final_norm": L.layernorm_specs(),
        "head": L.lm_head_specs(),
    }


def state_specs(cfg: ModelConfig):
    return {"tm_shift": (None, "batch", None, "embed"),
            "cm_shift": (None, "batch", None, "embed"),
            "wkv": (None, "batch", "heads", None, None),
            "pos": ()}


def init_rwkv6(seed: int, cfg: ModelConfig, device="cuda"):
    """Random parameters in ``cfg.dtype`` from a ``torch.Generator`` seeded
    with ``seed``, on ``device``, with the reference's distributions and
    layout; layers are drawn one after another into ``(n_layers, ...)``
    leaves."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = cfg.dtype
    p = {"embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt, dev),
         "ln0": L.init_layernorm(cfg.d_model, dt, dev)}
    layers = None
    for i in range(cfg.n_layers):
        one = _init_layer(gen, cfg, dev)
        if layers is None:
            layers = T._map(
                lambda a: a.new_empty((cfg.n_layers,) + tuple(a.shape)), one)
        T._fill(layers, one, i)
    p["layers"] = layers
    p["final_norm"] = L.init_layernorm(cfg.d_model, dt, dev)
    p["head"] = L.init_lm_head(gen, cfg.d_model, cfg.vocab_size, dt, dev)
    return p


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _ddlerp(p, x, shifted):
    """Data-dependent lerp producing the 5 mixed inputs (r,k,v,w,g); the
    LoRA runs in f32."""
    delta = shifted - x
    xxx = x + delta * p["maa_x"]
    b, s, _ = x.shape
    f = torch.tanh(xxx.float() @ p["maa_A"].float())
    f = f.reshape(b, s, 5, LORA_MAA)
    mixes = torch.einsum("bsfl,fld->fbsd", f, p["maa_B"].float())
    mixes = mixes + p["maa_rkvwg"].float()[:, None, None, :]
    return tuple(x + delta * mixes[i].to(x.dtype) for i in range(5))


def _shift(x, prev=None):
    """Token shift: previous token's features (prev fills t=0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def time_mix(p, cfg: ModelConfig, x, *, shift_prev=None, wkv_state=None,
             chunked: bool = True, wkv_impl: str = "auto", tp=None):
    """-> (out, last token's x for the next shift, WKV state).  A chunked
    call with S a multiple of ``CHUNK`` (and S > 1) takes
    ``ops.rwkv6_wkv_op`` with ``wkv_impl`` ("auto": the CUDA kernel on the
    card); everything else, decode included, the plain recurrence.  With
    ``tp`` cutting the heads, this member's H / n heads (the module
    docstring)."""
    b, s, _ = x.shape
    group, n, m = _member(tp, tp is not None and tp.heads)
    h, d = n_heads(cfg) // n, cfg.d_model // n
    cols = slice(m * d, (m + 1) * d)
    shifted = _shift(x, shift_prev)
    xr, xk, xv, xw, xg = _ddlerp(p, x, shifted)
    xr, xk, xv, xg = (TP.copy_to(t, group) for t in (xr, xk, xv, xg))
    r = L.dense(p["wr"], xr).reshape(b, s, h, HEAD_SIZE)
    k = L.dense(p["wk"], xk).reshape(b, s, h, HEAD_SIZE)
    v = L.dense(p["wv"], xv).reshape(b, s, h, HEAD_SIZE)
    g = F.silu(L.dense(p["wg"], xg))
    lora = TP.copy_to(torch.tanh(xw.float() @ p["decay_A"].float()), group)
    dec = _cols(p["time_decay"], group, cols).float() + \
        lora @ _cols(p["decay_B"], group, cols).float()
    logw = -torch.exp(dec).reshape(b, s, h, HEAD_SIZE)
    if wkv_state is None:
        wkv_state = torch.zeros((b, h, HEAD_SIZE, HEAD_SIZE),
                                dtype=torch.float32, device=x.device)
    args = (r.float(), k.float(), v.float(), logw, p["time_faaaa"],
            wkv_state)
    if chunked and s % CHUNK == 0 and s > 1:
        out, wkv_state = ops.rwkv6_wkv_op(*args, impl=wkv_impl,
                                          chunk=CHUNK)
    else:
        out, wkv_state = wkv_recurrent(*args)
    # per-head group norm (population variance, as jnp.var) + gate
    var, mu = torch.var_mean(out, dim=-1, keepdim=True, correction=0)
    out = (out - mu) * torch.rsqrt(var + 64e-5)
    ln_x = {k: _cols(v, group, cols) for k, v in p["ln_x"].items()}
    out = out.reshape(b, s, d) * ln_x["scale"] + ln_x["bias"]
    out = out.to(x.dtype) * g
    return TP.reduce_from(L.dense(p["wo"], out), group), x[:, -1:], \
        wkv_state


def channel_mix(p, x, *, shift_prev=None, tp=None):
    """With ``tp`` cutting the MLP width, this member's ``cm_k`` columns and
    ``cm_v`` rows, the ``cm_v`` product summed over the members."""
    group, _, _ = _member(tp, tp is not None and tp.mlp)
    shifted = _shift(x, shift_prev)
    delta = shifted - x
    xk = x + delta * p["cm_maa_k"]
    xr = x + delta * p["cm_maa_r"]
    kk = torch.relu(L.dense(p["cm_k"], TP.copy_to(xk, group))).square()
    return torch.sigmoid(L.dense(p["cm_r"], xr)) * TP.reduce_from(
        L.dense(p["cm_v"], kk), group), x[:, -1:]


def block(p, cfg: ModelConfig, x, state=None, chunked: bool = True, *,
          wkv_impl: str = "auto", tp=None):
    """state: None (full sequence) or dict(tm_shift (B,1,D), cm_shift,
    wkv (B,H,K,V)); H is this member's heads under ``tp``."""
    st = state or {}
    tm_out, tm_shift, wkv = time_mix(
        p, cfg, L.layernorm(p["ln1"], x), shift_prev=st.get("tm_shift"),
        wkv_state=st.get("wkv"), chunked=chunked, wkv_impl=wkv_impl, tp=tp)
    x = x + tm_out
    cm_out, cm_shift = channel_mix(p, L.layernorm(p["ln2"], x),
                                   shift_prev=st.get("cm_shift"), tp=tp)
    x = x + cm_out
    return x, {"tm_shift": tm_shift, "cm_shift": cm_shift, "wkv": wkv}


# ---------------------------------------------------------------------------
# model-level API (transformer.py's contract)
# ---------------------------------------------------------------------------


def _cast(params, cfg: ModelConfig):
    cdt = L.dtype_of(cfg.dtype)
    pc = T.cast_params({k: v for k, v in params.items() if k != "layers"},
                       cdt)
    return pc, T.cast_params(params["layers"], cdt)


def _stack_states(states):
    return {key: torch.stack([st[key] for st in states])
            for key in ("tm_shift", "cm_shift", "wkv")}


def forward(params, cfg: ModelConfig, tokens, *, collect_cache: bool = False,
            remat: bool = True, last_only: bool = False,
            wkv_impl: str = "auto"):
    """Returns (logits, aux_loss), and with ``collect_cache`` the layers'
    final states stacked on a leading layer axis.  ``remat`` runs each
    layer under ``cfg.remat`` when grad is enabled (training).
    ``last_only`` slices the stream before the LM head.  ``wkv_impl`` picks
    the WKV of ``kernels/ops.py`` ("auto": the CUDA kernel on the card;
    "interpret": the plain chunked version; "ref": the exact recurrence);
    under autograd the chunked op goes through ``ops.Rwkv6WkvFn``."""
    if wkv_impl not in ops.IMPLS:
        raise ValueError(f"unknown wkv_impl {wkv_impl!r}; have {ops.IMPLS}")
    tp = TP.plan(cfg)
    pc, layers = _cast(params, cfg)
    x = L.layernorm(pc["ln0"], T.embed_inputs(pc, cfg, tokens, tp=tp))

    def layer(x, lp):
        return block(lp, cfg, x, wkv_impl=wkv_impl, tp=tp)

    body = T._remat(layer, cfg) if remat else layer
    states = []
    for lp in T.unbind_groups(layers, cfg.n_layers):
        x, st = body(x, lp)
        if collect_cache:
            states.append(st)
    x = L.layernorm(pc["final_norm"], x[:, -1:] if last_only else x)
    logits = _head(pc, x, tp)
    aux = logits.new_zeros((), dtype=torch.float32)
    if collect_cache:
        return logits, aux, _stack_states(states)
    return logits, aux


def _head(pc, x, tp):
    """The LM head, vocab-parallel under ``tp``."""
    group, _, _ = _member(tp, tp is not None and tp.vocab)
    return L.lm_head(pc["head"], x, group=group)


def make_state(cfg: ModelConfig, batch: int, dtype=None, device="cuda"):
    """Zero state {"tm_shift", "cm_shift": (L, B, 1, D), "wkv":
    (L, B, H, K, V) f32, "pos": 0}; ``pos`` is a host int.  Under the
    ambient mesh H is this member's heads."""
    dev = resolve_device(device)
    dt = L.dtype_of(dtype or cfg.dtype)
    tp = TP.plan(cfg)
    _, n, _ = _member(tp, tp is not None and tp.heads)
    shift = (cfg.n_layers, batch, 1, cfg.d_model)
    return {
        "tm_shift": torch.zeros(shift, dtype=dt, device=dev),
        "cm_shift": torch.zeros(shift, dtype=dt, device=dev),
        "wkv": torch.zeros((cfg.n_layers, batch, n_heads(cfg) // n,
                            HEAD_SIZE, HEAD_SIZE), dtype=torch.float32,
                           device=dev),
        "pos": 0,
    }


def decode_step(params, cfg: ModelConfig, tokens, state):
    """tokens: (B,1).  Returns (logits (B,1,V), new state); the state handed
    in is not changed."""
    tp = TP.plan(cfg)
    pc, layers = _cast(params, cfg)
    x = L.layernorm(pc["ln0"], T.embed_inputs(pc, cfg, tokens, tp=tp))
    states = []
    for i in range(cfg.n_layers):
        x, st = block(T._map(lambda a: a[i], layers), cfg, x,
                      state={key: state[key][i]
                             for key in ("tm_shift", "cm_shift", "wkv")},
                      chunked=False, tp=tp)
        states.append(st)
    x = L.layernorm(pc["final_norm"], x)
    logits = _head(pc, x, tp)
    return logits, dict(_stack_states(states), pos=state["pos"] + 1)
