"""One member of the port's rwkv6, zamba2 and whisper runs over members
(gloo).

    python tests/_torch_members_ssm_worker.py <rank> <world_size> <dir>

Reads ``<dir>/inputs.npz`` (the reference's parameters per case of
:data:`CASES`, flattened ``<case>/<path>``; the prompts ``serve/*``, the
decode tokens, the batches ``grad/*`` and ``train/*``, whisper's with
frames; a reference zamba2 checkpoint under ``<dir>/jax_ckpt``), joins a
gloo group through ``file://<dir>/store`` and writes
``<dir>/out_<rank>.npz``:

- ``<case>/roundtrip``, ``<case>/n_cut``: ``shard_params`` then
  ``gather_tree`` bit-identical to the whole tree, and how many leaves are
  cut;
- ``<case>/logits``: ``api.forward`` (f32) on a (1, P) mesh under
  ``arch_rules``;
- ``<case>/collect/*``: rwkv6's and zamba2's ``forward(collect_cache=
  True)`` states, this member's heads gathered to whole ones;
- ``<case>/prefill``, ``<case>/decode<i>``, ``<case>/cache/*``: the prompt
  fed token by token through ``decode_step`` (the last prompt step's
  logits), then :data:`DECODE` steps fed ``decode_toks``, and the final
  cache gathered (zamba2's conv state through its segmented layout);
- ``<case>/tokens``: ``LMEngine`` tokens;
- ``<case>/grad/<path>``, ``<case>/loss``: the gradient of the training
  loss, gathered to whole leaves;
- ``train/<name>/{loss,grad_norm,lr}``: ``make_train_step`` on a (1, P)
  (tensor-parallel; whisper replicated) and a (P, 1) (data-parallel) mesh,
  at P = 2, and for :data:`BF16_CASES` again computing in bf16
  (``<name>`` ``tp_rwkv6_bf16`` ...);
- ``ckpt/*`` (P = 2): a laid-out zamba2 state saved to ``<dir>/port_ckpt``
  (the reference reads it) and the reference's checkpoint restored onto
  the mesh;
- ``reshard/*`` (P = 4): zamba2's parameters moved from a (1, 4) layout
  onto a (2, 2) one by ``elastic.reshard``, gathered.

Imports only the port (``src`` on PYTHONPATH).
"""
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import base as cb
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs
from repro_torch.models import api
from repro_torch.models import rwkv6 as R
from repro_torch.models import zamba2 as Z
from repro_torch.runtime import checkpoint as C
from repro_torch.runtime import elastic
from repro_torch.serving.engine import LMEngine
from repro_torch.sharding import partition
from repro_torch.sharding import tp as TP
from repro_torch.train import optimizer as opt
from repro_torch.train import steps as steps_mod

CASES = {"rwkv6": "rwkv6-1.6b", "zamba2": "zamba2-2.7b",
         "whisper": "whisper-tiny"}
B, S, DECODE, GEN, MAX_LEN = 2, 16, 8, 6, 32
# the train steps' batch: S 32 takes rwkv6's chunked WKV (ops.Rwkv6WkvFn)
TRAIN_B, TRAIN_S = 4, 32
# the cases whose train steps also run computing in bf16
BF16_CASES = ("rwkv6", "zamba2")


def config(case):
    return cb.get_arch(CASES[case]).smoke()


def nested(data, prefix):
    out = {}
    for k, v in data.items():
        if not k.startswith(prefix + "/"):
            continue
        node, parts = out, k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(v))
    return out


def flat(prefix, tree, out):
    for k, v in C._flatten(tree).items():
        out[f"{prefix}/{k}"] = v.detach().numpy()


def rules_for(cfg, mesh, kind, seq=S, batch=B):
    return specs.arch_rules(cfg, mesh, ShapeConfig("t", kind, seq, batch))


def batch_of(cfg, data, prefix, keys=("tokens", "labels")):
    """The batch stored under ``prefix`` (whisper's with its frames)."""
    out = {k: torch.from_numpy(data[prefix + k]) for k in keys}
    if cfg.family == "audio":
        out["frames"] = torch.from_numpy(data[prefix + "frames"])
    return out


def cache_layout(cfg):
    """The logical layout of a member's cache on the model axis: its heads
    (zamba2's conv channels as the fused x | B | C segments)."""
    tp = TP.plan(cfg)
    if cfg.family == "ssm":
        heads = "model" if tp is not None and tp.heads else None
        return {"tm_shift": (None,) * 4, "cm_shift": (None,) * 4,
                "wkv": (None, None, heads, None, None)}
    kv = "model" if tp is not None and tp.heads and tp.kv == "cut" else None
    seg = api._segments(cfg, ("mamba", "conv_w")) \
        if tp is not None and tp.ssm_heads else None
    heads = "model" if seg is not None else None
    return {"attn_k": (None, None, None, kv, None),
            "attn_v": (None, None, None, kv, None),
            "conv": (None, None, None, None, seg),
            "ssd": (None, None, None, heads, None, None)}


def gathered(tree, specs_, mesh):
    return {k: partition.gather_leaf(tree[k], s, mesh)
            for k, s in specs_.items()}


def serve_case(case, data, mesh, out):
    cfg = config(case)
    full = nested(data, case)
    batch = batch_of(cfg, data, "serve/", ("tokens",))
    toks = batch["tokens"]
    with partition.axis_rules(mesh, rules_for(cfg, mesh, "prefill")):
        layout = api.param_layout(cfg)
        params = api.shard_params(full, cfg)
        back = partition.gather_tree(params, layout)
        out[f"{case}/roundtrip"] = np.array(all(
            torch.equal(a, b) for a, b in zip(
                opt.leaves(back), opt.leaves(full), strict=True)))
        out[f"{case}/n_cut"] = np.array(sum(opt.leaves(partition.map_specs(
            lambda _, s: partition.is_cut(s), layout.specs))))
        cspec = None if cfg.family == "audio" else cache_layout(cfg)
        with torch.no_grad():
            logits, _ = api.forward(params, cfg, batch, remat=False)
            out[f"{case}/logits"] = logits.numpy()
            if cfg.family == "ssm":
                _, _, st = R.forward(params, cfg, toks, collect_cache=True)
                flat(f"{case}/collect", gathered(st, cspec, mesh), out)
            elif cfg.family == "hybrid":
                _, _, ((k, v), st) = Z.forward(params, cfg, toks,
                                               collect_cache=True)
                flat(f"{case}/collect", gathered(
                    {"k": k, "v": v, "ssd": st["ssd"]},
                    {"k": cspec["attn_k"], "v": cspec["attn_v"],
                     "ssd": cspec["ssd"]}, mesh), out)
            cache = api.make_cache(cfg, B, MAX_LEN, device="cpu")
            for t in range(S):
                lg, cache = api.decode_step(params, cfg, toks[:, t:t + 1],
                                            cache)
            out[f"{case}/prefill"] = lg.numpy()
            feed = torch.from_numpy(data["decode_toks"])
            for i in range(DECODE):
                lg, cache = api.decode_step(params, cfg, feed[:, i:i + 1],
                                            cache)
                out[f"{case}/decode{i}"] = lg.numpy()
            if cspec is not None:
                flat(f"{case}/cache", gathered(cache, cspec, mesh), out)
            eng = LMEngine(params, cfg, max_len=MAX_LEN, device="cpu")
            out[f"{case}/tokens"] = eng.generate(data["serve/tokens"], GEN)
        # gradients of the training loss, gathered to whole leaves
        leaves = opt.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        tb = batch_of(cfg, data, "grad/")
        logits, aux = api.forward(params, cfg, tb, remat=True)
        loss = api.loss(cfg, logits, tb["labels"], aux)
        loss.backward()
        grads = partition.map_specs(lambda _, s, p: p.grad, layout.specs,
                                    params)
        out[f"{case}/loss"] = loss.detach().numpy()
        flat(f"{case}/grad", partition.gather_tree(grads, layout), out)
        for p in leaves:
            p.requires_grad_(False)
            p.grad = None


def train_case(name, case, data, mesh, out, dtype=None):
    cfg = config(case)
    cfg = cfg.replace(dtype=dtype or cfg.dtype)
    full = nested(data, case)
    batch = batch_of(cfg, data, "train/")
    with partition.axis_rules(mesh, rules_for(cfg, mesh, "train",
                                              seq=TRAIN_S, batch=TRAIN_B)):
        params = api.shard_params(full, cfg)
        state = opt.adamw_init(params)
        step = steps_mod.make_train_step(cfg)
        params, state, m = step(params, state, batch)
    for k in ("loss", "grad_norm", "lr"):
        out[f"train/{name}/{k}"] = m[k].numpy()


def ckpt_case(d, data, mesh, out):
    """A laid-out zamba2 training state saved (the reference restores it)
    and the reference's checkpoint restored onto the mesh."""
    cfg = config("zamba2")
    full = nested(data, "zamba2")
    with partition.axis_rules(mesh, rules_for(cfg, mesh, "train")):
        layout = api.param_layout(cfg)
        params = api.shard_params(full, cfg)
        state = (params, opt.adamw_init(params))
        st_layout = partition.Layout(mesh, (layout.specs,
                                            opt.adamw_layout(layout).specs))
        C.save(str(d / "port_ckpt"), 3, state, layout=st_layout)
        (got, _), step = C.restore(str(d / "jax_ckpt"), state,
                                   layout=st_layout)
        back = partition.gather_tree(got, layout)
    out["ckpt/step"] = np.array(step)
    flat("ckpt/restored", back, out)


def reshard_case(data, out):
    """zamba2's parameters laid out over a (1, 4) mesh moved onto a (2, 2)
    one by ``elastic.reshard`` (every rank survives), gathered back."""
    cfg = config("zamba2")
    full = nested(data, "zamba2")
    layouts = []
    for model in (4, 2):
        m = mesh_mod.make_host_mesh(model=model)
        with partition.axis_rules(m, rules_for(cfg, m, "train")):
            layouts.append(api.param_layout(cfg))
    params = partition.shard_tree(full, layouts[0])
    moved = elastic.reshard(params, layouts[0], layouts[1])
    flat("reshard/params", partition.gather_tree(moved, layouts[1]), out)


def main(rank, world, d):
    torch.set_num_threads(1)
    data = dict(np.load(d / "inputs.npz"))
    mesh_mod.init_model_group("gloo", world, rank, f"file://{d / 'store'}")
    out = {}
    try:
        tp_mesh = mesh_mod.make_host_mesh(model=world)
        dp_mesh = mesh_mod.make_host_mesh(model=1)
        for case in CASES:
            serve_case(case, data, tp_mesh, out)
        if world == 2:
            for case in CASES:
                train_case(f"tp_{case}", case, data, tp_mesh, out)
                train_case(f"dp_{case}", case, data, dp_mesh, out)
            for case in BF16_CASES:
                for mode, m in (("tp", tp_mesh), ("dp", dp_mesh)):
                    train_case(f"{mode}_{case}_bf16", case, data, m, out,
                               dtype="bfloat16")
            ckpt_case(d, data, tp_mesh, out)
        if world == 4:
            reshard_case(data, out)
    finally:
        np.savez(d / f"out_{rank}.npz", **out)
        mesh_mod.destroy_model_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
