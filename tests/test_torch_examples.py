"""The port's twins of ``examples/quickstart.py`` and
``examples/serve_lm_decode.py`` against the reference's, on the CPU.

The quickstart's printed lines are held to the reference's: the BLS and
schedule-simulator lines exactly, the DLRM CTRs (the reference's
parameters, converted) at f32 rtol = atol = 1e-5 (sums in other orders).
The LM decode twin must serve the reference's arch choices and, on the
reference's parameters, the reference's tokens exactly, for one dense and
one recurrent arch.
"""
import runpy
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.configs import dlrm_kaggle as jkaggle
from repro.models import api as japi
from repro.models import dlrm as jdlrm
from repro.serving import engine as jengine
from repro_torch.examples import quickstart, serve_lm_decode
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import transformer as tT

ROOT = Path(__file__).resolve().parents[1]
CTR_TOL = {"rtol": 1e-5, "atol": 1e-5}


def _ctrs(line: str) -> np.ndarray:
    return np.array(line.split("[", 1)[1].rstrip("]").split(), np.float32)


def test_quickstart_prints_the_references_values(capsys):
    runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                   run_name="__main__")
    want = capsys.readouterr().out.splitlines()
    jp = jdlrm.init_dlrm(jax.random.PRNGKey(1), jkaggle.smoke(), n_shards=1)
    quickstart.main(["--device", "cpu"],
                    params=tdlrm.params_from_jax(
                        jax.tree.map(np.asarray, jp), "cpu"))
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 7
    ctr = [i for i, line in enumerate(want) if line.startswith("DLRM CTR")]
    assert ctr == [5]
    assert got[:5] == want[:5] and got[6:] == want[6:]
    np.testing.assert_allclose(_ctrs(got[5]), _ctrs(want[5]), **CTR_TOL)


def test_serve_lm_decode_offers_the_references_archs():
    want = [a for a in jbase.list_archs()
            if not a.startswith(("dlrm", "whisper", "llava"))]
    assert serve_lm_decode.arch_choices() == want
    assert "zamba2-2.7b" in want


@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-1.6b", "zamba2-2.7b"])
def test_serve_lm_decode_serves_the_references_tokens(arch, capsys):
    jcfg = jbase.get_arch(arch).smoke()
    jp = japi.init(jax.random.PRNGKey(0), jcfg, n_shards=1)
    tp = tT.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    want = jengine.LMEngine(jp, jcfg, max_len=6 + 5).generate(prompts, 5)
    got = serve_lm_decode.main(["--arch", arch, "--batch", "2",
                                "--prompt-len", "6", "--tokens", "5",
                                "--device", "cpu"], params=tp)
    np.testing.assert_array_equal(got, want)
    out = capsys.readouterr().out
    assert f"{arch} ({jcfg.name}): generated (2, 5) tokens" in out
    assert "per-token latency p50=" in out
