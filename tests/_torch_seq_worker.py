"""One member of the port's sequence-axis runs (gloo).

    python tests/_torch_seq_worker.py <rank> <world_size> <dir>

Reads ``<dir>/inputs.npz`` (the reference's parameters per case,
flattened ``<case>/<path>``; per-rank collective inputs; prompts, decode
tokens, training batches, patches, whisper's whole cache), joins a gloo
group through ``file://<dir>/store`` and writes ``<dir>/out_<rank>.npz``:

- ``coll/<name>/{out,grad}``: ``tp.gather_seq`` / ``scatter_seq`` /
  ``split_seq`` / ``own_seq`` forward on this rank's input and backward of
  this rank's upstream gradient, over the model group of a (1, P) mesh;
- ``dec/<case>/{cache_shape,prefill,step<i>}``: under the decode rules
  (``kv_seq`` over ``model``), the cache of this member (every KV head, a
  block of positions), the prefill's last logits and :data:`STEPS` decode
  steps, the last ones past the cache's end; whisper decodes from its
  cut of the reference's whole cache; at P = 4 zamba2 decodes a batch of
  1 from a zero cache on a (2, 2) mesh under the batch-1 rule (``kv_seq``
  over (data, model));
- ``train/<case>/{loss,grad/<path>}``: under the train rules (``res_seq``
  over ``model``) the training loss and every leaf's gradient, gathered
  whole, on a (1, P) mesh;
- ``plan/<case>``: the plan's attention mode ("cut", "select", "full").

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
from repro_torch.models import transformer as T
from repro_torch.models import whisper as Wh
from repro_torch.runtime import checkpoint as C
from repro_torch.sharding import partition
from repro_torch.sharding import tp as TP
from repro_torch.train import optimizer as opt

# name -> arch; every MoE case is drawn with n_shards 4
DECODE_CASES = {"gemma2": "gemma2-9b", "qwen3": "qwen3-14b",
                "chatglm3": "chatglm3-6b", "granite": "granite-moe-3b-a800m",
                "qwen2moe": "qwen2-moe-a2.7b", "whisper": "whisper-tiny"}
TRAIN_CASES = {"gemma2": "gemma2-9b", "qwen3": "qwen3-14b",
               "qwen3_whole": "qwen3-14b", "qwen2moe": "qwen2-moe-a2.7b",
               "granite": "granite-moe-3b-a800m",
               "llava": "llava-next-mistral-7b"}
# qwen3 with a hidden width and a vocabulary no P divides: its MLP, its
# embedding and its head run whole on the sequence-cut stream
WHOLE = {"d_ff": 129, "vocab_size": 513}
N_SHARDS = 4
B = 2
# a prompt shorter than one block at P = 2 (11) and 4 (6); 22 positions
# do not divide into 4 blocks, and the last two steps land past the end
PROMPT, MAX_LEN = 5, 22
STEPS = MAX_LEN - PROMPT + 2
ENC = 8                      # whisper's encoder positions
S_TRAIN, TRAIN_B = 16, 2
N_PATCH_TOKENS = 8           # llava: 8 patches + 8 tokens = 16 positions
COLL_S, COLL_D = 8, 3


def config(case):
    arch = {**DECODE_CASES, **TRAIN_CASES, "zamba2": "zamba2-2.7b"}[case]
    cfg = cb.get_arch(arch).smoke()
    return cfg.replace(**WHOLE) if case == "qwen3_whole" else cfg


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


def rules_for(cfg, mesh, kind, seq, batch):
    return specs.arch_rules(cfg, mesh, ShapeConfig("t", kind, seq, batch))


def collectives(data, mesh, rank, out):
    g = mesh.group("model")
    for name, fn in (("gather", TP.gather_seq), ("scatter", TP.scatter_seq),
                     ("split", TP.split_seq), ("own", TP.own_seq)):
        x = torch.from_numpy(data[f"coll/{name}/x"][rank]).requires_grad_()
        y = fn(x, g)
        y.backward(torch.from_numpy(data[f"coll/{name}/g"][rank]))
        out[f"coll/{name}/out"] = y.detach().numpy()
        out[f"coll/{name}/grad"] = x.grad.numpy()


def _block(a, cut, dim):
    """This member's block of the whole array ``a`` along ``dim``, zero
    past its end."""
    size = cut.size(a.shape[dim])
    lo = cut.m * size
    part = np.take(a, range(lo, min(lo + size, a.shape[dim])), axis=dim)
    pad = [(0, 0)] * a.ndim
    pad[dim] = (0, size - part.shape[dim])
    return torch.from_numpy(np.pad(part, pad))


def decode_case(case, data, mesh, out):
    cfg = config(case)
    full = nested(data, case)
    feed = torch.from_numpy(data["decode_toks"])
    with partition.axis_rules(mesh, rules_for(cfg, mesh, "decode", MAX_LEN,
                                              B)), torch.no_grad():
        params = api.shard_params(full, cfg)
        tp = TP.plan(cfg)
        cut = TP.cache_cut(tp)
        out[f"plan/{case}"] = np.array(tp.kv if tp.heads else "full")
        if cfg.family == "audio":
            cache = Wh.make_cache(cfg, B, MAX_LEN, ENC, device="cpu")
            for k in ("self_k", "self_v", "cross_k", "cross_v"):
                cache[k].copy_(_block(data[f"whisper_cache/{k}"], cut, 2))
            cache["pos"] = int(data["whisper_cache/pos"])
        else:
            last, cache = T.prefill(params, cfg,
                                    torch.from_numpy(data["prompts"]),
                                    pad_to=MAX_LEN)
            out[f"dec/{case}/prefill"] = last.numpy()
        key = "self_k" if cfg.family == "audio" else "k"
        out[f"dec/{case}/cache_shape"] = np.array(cache[key].shape)
        for i in range(STEPS):
            lg, cache = api.decode_step(params, cfg, feed[:, i:i + 1], cache)
            out[f"dec/{case}/step{i}"] = lg.numpy()


def zamba2_case(data, out):
    """A batch of 1 on a (2, 2) mesh under the batch-1 rule: the prompt fed
    token by token from a zero cache, then the decode tokens."""
    cfg = config("zamba2")
    mesh = mesh_mod.make_host_mesh(model=2)
    full = nested(data, "zamba2")
    toks = np.concatenate([data["prompts"][:1], data["decode_toks"][:1]],
                          axis=1)
    with partition.axis_rules(mesh, rules_for(cfg, mesh, "decode", MAX_LEN,
                                              1)), torch.no_grad():
        params = api.shard_params(full, cfg)
        cache = api.make_cache(cfg, 1, MAX_LEN, device="cpu")
        out["dec/zamba2/cut"] = np.array(TP.cache_cut(TP.plan(cfg)).axes)
        out["dec/zamba2/cache_shape"] = np.array(cache["attn_k"].shape)
        for i in range(toks.shape[1]):
            lg, cache = api.decode_step(
                params, cfg, torch.from_numpy(toks[:, i:i + 1]), cache)
            out[f"dec/zamba2/step{i}"] = lg.numpy()


def train_case(case, data, mesh, out):
    cfg = config(case)
    full = nested(data, case)
    batch = {k: torch.from_numpy(data[f"train/{case}/{k}"])
             for k in ("tokens", "labels", "patches")
             if f"train/{case}/{k}" in data}
    with partition.axis_rules(mesh, rules_for(cfg, mesh, "train", S_TRAIN,
                                              TRAIN_B)):
        assert TP.plan(cfg).res_seq
        layout = api.param_layout(cfg)
        params = api.shard_params(full, cfg)
        leaves = opt.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        logits, aux = api.forward(params, cfg, batch, remat=True)
        loss = api.loss(cfg, logits, batch["labels"], aux)
        loss.backward()
        grads = partition.map_specs(lambda _, s, p: p.grad, layout.specs,
                                    params)
        out[f"train/{case}/loss"] = loss.detach().numpy()
        for k, v in C._flatten(partition.gather_tree(grads, layout)).items():
            out[f"train/{case}/grad/{k}"] = v.numpy()


def main(rank, world, d):
    torch.set_num_threads(1)
    data = dict(np.load(d / "inputs.npz"))
    mesh_mod.init_model_group("gloo", world, rank, f"file://{d / 'store'}")
    out = {}
    try:
        mesh = mesh_mod.make_host_mesh(model=world)
        collectives(data, mesh, rank, out)
        for case in DECODE_CASES:
            decode_case(case, data, mesh, out)
        for case in TRAIN_CASES:
            train_case(case, data, mesh, out)
        if world == 4:
            zamba2_case(data, out)
    finally:
        np.savez(d / f"out_{rank}.npz", **out)
        mesh_mod.destroy_model_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
