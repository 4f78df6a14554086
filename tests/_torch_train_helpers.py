"""Shared by ``tests/test_torch_train.py`` and
``tests/test_torch_train_runtime.py``: one LM arch's smoke config trained
by the port and by the JAX reference on the same parameters and batches.

Parameters are the reference's ``api.init`` leaves carried over as f32
masters (``params_from_jax``); batches come from the port's
``launch/train.py::synthetic_batches`` (numpy ``default_rng``, as the
reference draws them).  The loss and each gradient leaf are held at a
relative (Frobenius) 1e-4 against ``jax.value_and_grad`` of the
reference's loss, then three ``make_train_step`` steps' loss, grad_norm
and lr at 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as jcb
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs import base as tcb
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import transformer as tT
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps

LM_ARCHS = [a for a in jcb.list_archs() if not a.startswith("dlrm")]
# the arch cases are split over the two files, so that pytest-xdist's
# loadfile spreads them (each file within ~90 s on one CPU)
TRAIN_FILE_ARCHS = ("gemma2-9b", "qwen2-72b", "qwen3-14b",
                    "llava-next-mistral-7b")
REL = 1e-4


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def converted(jp):
    return tT.params_from_jax(jax.tree.map(np.asarray, jp), "cpu",
                              dtype="float32")


def batches(cfg, n, seed, seq=32):
    """Port batches (CPU tensors) and the same arrays for JAX."""
    tb = list(ttrain.synthetic_batches(cfg, 2, seq, n, seed))
    return tb, [{k: jnp.asarray(v.numpy()) for k, v in b.items()}
                for b in tb]


def check_train_step(arch):
    """The port's gradients and three train steps of ``arch``'s smoke
    config against the reference's."""
    jcfg, tcfg = jcb.get_arch(arch).smoke(), tcb.get_arch(arch).smoke()
    jp = japi.init(jax.random.PRNGKey(1), jcfg, 1)
    tp = converted(jp)
    tb, jb = batches(tcfg, 3, seed=len(arch))

    def jloss(p, b):
        logits, aux = japi.forward(p, jcfg, b, remat=True)
        return japi.loss(jcfg, logits, b["labels"], aux)

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(jp, jb[0])
    flat = topt.leaves(tp)
    for p in flat:
        p.requires_grad_(True)
    logits, aux = tapi.forward(tp, tcfg, tb[0])
    loss = tapi.loss(tcfg, logits, tb[0]["labels"], aux)
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(want_loss)) <= REL * abs(float(want_loss))
    want_leaves = jax.tree.leaves(want)
    assert len(want_leaves) == len(flat)
    for p, w in zip(flat, want_leaves):
        assert p.grad is not None and p.grad.shape == w.shape
        assert rel_err(p.grad.numpy(), w) < REL, (arch, p.shape)
    grad_norm = topt.global_norm([p.grad for p in flat])
    assert rel_err(grad_norm.numpy(), jopt.global_norm(want)) < REL
    for p in flat:
        p.requires_grad_(False)
        p.grad = None

    jstep = jax.jit(jsteps.make_train_step(jcfg))
    tstep = tsteps.make_train_step(tcfg)
    jst, tst = jopt.adamw_init(jp), topt.adamw_init(tp)
    for t_batch, j_batch in zip(tb, jb):
        jp, jst, jm = jstep(jp, jst, j_batch)
        tp, tst, tm = tstep(tp, tst, t_batch)
        for key in ("loss", "grad_norm", "lr"):
            assert rel_err(tm[key].numpy(), jm[key]) < REL, (arch, key)
    assert int(tst["count"]) == 3
    # the parameters moved (a leaf-by-leaf comparison is ill-conditioned:
    # a leaf whose exact gradient is 0, as a key bias's, takes AdamW steps
    # of +-lr on rounding noise in either framework)
    assert any(not torch.equal(a, b) for a, b in
               zip(topt.leaves(tp), topt.leaves(converted(
                   japi.init(jax.random.PRNGKey(1), jcfg, 1)))))
