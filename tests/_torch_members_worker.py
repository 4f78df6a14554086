"""One member of the port's LM-over-members runs (gloo).

    python tests/_torch_members_worker.py <rank> <world_size> <dir>

Reads ``<dir>/inputs.npz`` (the reference's parameters per case of
:data:`CASES`, flattened ``<case>/<path>``; prompts, patches, training
batches, per-rank ``psum/x``, a reference checkpoint under
``<dir>/jax_ckpt``), joins a gloo group through ``file://<dir>/store`` and
writes ``<dir>/out_<rank>.npz``:

- ``<case>/roundtrip``: ``shard_params`` then ``gather_tree`` bit-identical
  to the whole tree;
- ``<case>/logits``, ``<case>/prefill``, ``<case>/decode<i>``,
  ``<case>/tokens``: ``api.forward`` (f32), ``prefill`` and 8 decode steps
  (fed ``decode_toks``),
  ``LMEngine`` tokens, on a (1, P) mesh under ``arch_rules``; a2a cases
  record whether decode raised (``<case>/decode_raised``);
- ``<case>/grad/<path>`` and ``<case>/loss``: the gradient of the training
  loss, gathered to whole leaves, on the (1, P) mesh (the text cases with
  the gather dispatch);
- ``train/<name>/{loss,grad_norm}``: ``make_train_step`` on a (1, P)
  (tensor-parallel) and a (P, 1) (data-parallel) mesh;
- ``psum``: ``compressed_psum`` of this rank's ``psum/x``;
- ``ckpt/*``: a laid-out state saved to ``<dir>/port_ckpt`` (the reference
  reads it) and the reference's checkpoint restored onto the mesh;
- ``elastic/*`` (last, at P = 4): an ``ElasticRunner`` that loses ranks 2
  and 3 at step :data:`FAIL_AT`, shrinks to 2 and restores.

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
from repro_torch.runtime import checkpoint as C
from repro_torch.runtime import elastic
from repro_torch.serving.engine import LMEngine
from repro_torch.sharding import partition
from repro_torch.train import grad_compression as GC
from repro_torch.train import optimizer as opt
from repro_torch.train import steps as steps_mod

# name -> (arch, MoE overrides); every MoE case is drawn with n_shards 4
CASES = {
    "gemma2": ("gemma2-9b", {}),
    "qwen3": ("qwen3-14b", {}),
    "chatglm3": ("chatglm3-6b", {}),
    "llava": ("llava-next-mistral-7b", {}),
    "qwen2moe": ("qwen2-moe-a2.7b", {}),
    "qwen2moe_a2a": ("qwen2-moe-a2.7b", {"dispatch": "a2a",
                                         "capacity_factor": 8.0}),
}
N_SHARDS = 4
B, S, PAD, DECODE, GEN = 2, 16, 32, 8, 6
TRAIN_B = 4
FAIL_AT, CKPT_EVERY, ELASTIC_STEPS = 5, 2, 8


def config(case):
    import dataclasses
    arch, moe_kw = CASES[case]
    cfg = cb.get_arch(arch).smoke()
    if moe_kw:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    return cfg


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


def serve_case(case, data, mesh, out):
    cfg = config(case)
    full = nested(data, case)
    toks = torch.from_numpy(data["prompts"])
    patches = (torch.from_numpy(data["patches"])
               if cfg.frontend != "none" else None)
    with partition.axis_rules(mesh, rules_for(cfg, mesh, "prefill")):
        layout = api.param_layout(cfg)
        params = api.shard_params(full, cfg)
        back = partition.gather_tree(params, layout)
        same = all(torch.equal(a, b) for a, b in zip(
            opt.leaves(back), opt.leaves(full), strict=True))
        out[f"{case}/roundtrip"] = np.array(same)
        out[f"{case}/n_cut"] = np.array(sum(
            opt.leaves(partition.map_specs(lambda _, s: "model" in s,
                                           layout.specs))))
        with torch.no_grad():
            batch = {"tokens": toks}
            if patches is not None:
                batch["patches"] = patches
            logits, _ = api.forward(params, cfg, batch, remat=False)
            out[f"{case}/logits"] = logits.numpy()
            if patches is not None:
                return
            last, cache = T.prefill(params, cfg, toks, pad_to=PAD)
            out[f"{case}/prefill"] = last.numpy()
            feed = torch.from_numpy(data["decode_toks"])
            try:
                for i in range(DECODE):
                    lg, cache = api.decode_step(params, cfg,
                                                feed[:, i:i + 1], cache)
                    out[f"{case}/decode{i}"] = lg.numpy()
                out[f"{case}/decode_raised"] = np.array(False)
            except ValueError as e:
                out[f"{case}/decode_raised"] = np.array(True)
                out[f"{case}/decode_error"] = np.array(str(e))
            if cfg.moe is None or cfg.moe.dispatch != "a2a":
                eng = LMEngine(params, cfg, max_len=PAD, device="cpu")
                out[f"{case}/tokens"] = eng.generate(data["prompts"], GEN)
        # gradients of the training loss, gathered to whole leaves
        if cfg.moe is not None and cfg.moe.dispatch == "a2a":
            return
        master = {k: v for k, v in params.items()}
        leaves = opt.leaves(master)
        for p in leaves:
            p.requires_grad_(True)
        tb = {k: torch.from_numpy(data[f"train/{k}"])
              for k in ("tokens", "labels")}
        logits, aux = api.forward(master, cfg, tb, remat=True)
        loss = api.loss(cfg, logits, tb["labels"], aux)
        loss.backward()
        grads = partition.map_specs(lambda _, s, p: p.grad, layout.specs,
                                    master)
        out[f"{case}/loss"] = loss.detach().numpy()
        flat(f"{case}/grad", partition.gather_tree(grads, layout), out)
        for p in leaves:
            p.requires_grad_(False)
            p.grad = None


def train_case(name, case, data, mesh, out, accum=1):
    cfg = config(case)
    full = nested(data, case)
    batch = {k: torch.from_numpy(data[f"train/{k}"])
             for k in ("tokens", "labels")}
    with partition.axis_rules(mesh, rules_for(cfg, mesh, "train",
                                              batch=TRAIN_B)):
        params = api.shard_params(full, cfg)
        state = opt.adamw_init(params)
        step = steps_mod.make_train_step(cfg, accum_steps=accum)
        params, state, m = step(params, state, batch)
    for k in ("loss", "grad_norm", "lr"):
        out[f"train/{name}/{k}"] = m[k].numpy()


def ckpt_case(d, data, mesh, out):
    """A laid-out training state saved (the reference restores it) and the
    reference's checkpoint restored onto the mesh."""
    cfg = config("qwen3")
    full = nested(data, "qwen3")
    with partition.axis_rules(mesh, rules_for(cfg, mesh, "train")):
        layout = api.param_layout(cfg)
        params = api.shard_params(full, cfg)
        state = (params, opt.adamw_init(params))
        st_layout = partition.Layout(mesh, (layout.specs,
                                            opt.adamw_layout(layout).specs))
        C.save(str(d / "port_ckpt"), 3, state, layout=st_layout)
        saver = C.AsyncCheckpointer(str(d / "port_async"))
        saver.save(3, state, layout=st_layout)
        saver.wait()
        (got, _), step = C.restore(str(d / "jax_ckpt"), state,
                                   layout=st_layout)
        back = partition.gather_tree(got, layout)
    out["ckpt/step"] = np.array(step)
    flat("ckpt/restored", back, out)


def elastic_case(d, data, out):
    """Data-parallel over every rank; ranks 2 and 3 drop at FAIL_AT; the
    survivors restore the last checkpoint onto the (1, 2) mesh of
    ``make_mesh_from`` (tensor-parallel) and replay."""
    cfg = config("qwen3")
    full = nested(data, "qwen3")
    batches = [{k: torch.from_numpy(data[f"elastic/{i}/{k}"])
                for k in ("tokens", "labels")}
               for i in range(ELASTIC_STEPS)]
    step = steps_mod.make_train_step(cfg)
    mesh = mesh_mod.make_host_mesh(model=1)

    def layout_of(m):
        with partition.axis_rules(m, rules_for(cfg, m, "train")):
            lay = api.param_layout(cfg)
        return partition.Layout(m, (lay.specs,
                                    opt.adamw_layout(lay).specs))

    losses = {}

    def step_fn(state, batch, m):
        with partition.axis_rules(m, rules_for(cfg, m, "train",
                                               batch=TRAIN_B)):
            p, s, met = step(*state, batch)
        losses[int(s["count"]) - 1] = float(met["loss"])
        return (p, s)

    def fault(i):
        if i == FAIL_AT and "failed" not in losses:
            losses["failed"] = 1.0
            raise elastic.NodeFailure([0, 1])

    params = partition.shard_tree(full, partition.Layout(
        mesh, layout_of(mesh).specs[0]))
    state = (params, opt.adamw_init(params))
    runner = elastic.ElasticRunner(make_shardings=layout_of,
                                   ckpt_dir=str(d / "elastic_ckpt"))
    try:
        state, new_mesh, rec = runner.run(
            state, lambda s: iter(batches[s:]), step_fn, mesh, fault=fault,
            ckpt_every=CKPT_EVERY)
    except elastic.Evicted:
        out["elastic/evicted"] = np.array(True)
        return
    out["elastic/evicted"] = np.array(False)
    out["elastic/recoveries"] = np.array(rec)
    out["elastic/mesh"] = np.array([new_mesh.shape["data"],
                                    new_mesh.shape["model"]])
    lay = layout_of(new_mesh)
    params = partition.gather_tree(state[0], partition.Layout(
        new_mesh, lay.specs[0]))
    flat("elastic/params", params, out)
    out["elastic/losses"] = np.array([losses[i] for i in
                                      range(ELASTIC_STEPS)])


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
            train_case("tp_qwen3", "qwen3", data, tp_mesh, out)
            train_case("dp_qwen3", "qwen3", data, dp_mesh, out)
            train_case("tp_qwen2moe", "qwen2moe", data, tp_mesh, out)
            train_case("dp_qwen2moe", "qwen2moe", data, dp_mesh, out)
            ckpt_case(d, data, tp_mesh, out)
        if world == 4:
            x = torch.from_numpy(data["psum/x"][rank])
            out["psum"] = GC.compressed_psum(x, dp_mesh.group("data")).numpy()
            elastic_case(d, data, out)
    finally:
        np.savez(d / f"out_{rank}.npz", **out)
        mesh_mod.destroy_model_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
