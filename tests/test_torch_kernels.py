"""The port's kernel modules (``repro_torch.kernels``) against the JAX
reference on the same numpy inputs, on the CPU.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
side runs its oracles and its Pallas kernels in interpret mode.  Bags and
the interaction are held at f32 rtol=1e-5, atol=1e-6: both sides sum in
f32 in different orders.  The CUDA kernels themselves are checked on the
card by chip_smoke.py.
"""
import ast
import ctypes
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dot_interaction as jdot
from repro.kernels import embedding_bag as jeb
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops
from repro_torch.kernels import dot_interaction as tdot
from repro_torch.kernels import embedding_bag as teb
from repro_torch.kernels import ref as tref

TOL = {"rtol": 1e-5, "atol": 1e-6}
ROOT = Path(__file__).resolve().parents[1]


def _stack(seed, t=3, r=40, s=8, b=12, hot=5, p_mask=0.7):
    rng = np.random.default_rng(seed)
    tables = rng.standard_normal((t, r, s), dtype=np.float32)
    idx = rng.integers(0, r, size=(b, t, hot), dtype=np.int32)
    mask = (rng.random((b, t, hot)) < p_mask).astype(np.float32)
    return tables, idx, mask


def _close(port, jax_out):
    np.testing.assert_allclose(port.numpy(), np.asarray(jax_out), **TOL)


class TestEmbeddingBag:
    @pytest.mark.parametrize("seed,hot", [(0, 1), (1, 5), (2, 33)])
    def test_stacked_matches_jax_ref(self, seed, hot):
        tables, idx, mask = _stack(seed, hot=hot)
        port = teb.embedding_bag_stacked(*map(torch.from_numpy,
                                              (tables, idx, mask)))
        _close(port, jref.embedding_bag_stacked_ref(tables, idx, mask))

    @pytest.mark.parametrize("row_block", [0, 16])
    def test_stacked_matches_jax_kernel_interpret(self, row_block):
        tables, idx, mask = _stack(3, r=48, hot=4)
        port = teb.embedding_bag_stacked(
            *map(torch.from_numpy, (tables, idx, mask)), row_block=row_block)
        out = jeb.embedding_bag_stacked(
            jnp.asarray(tables), jnp.asarray(idx), jnp.asarray(mask),
            row_block=row_block, interpret=True)
        _close(port, out)

    def test_rows_matches_jax_kernel_interpret(self):
        tables, idx, mask = _stack(4, r=32, hot=6)
        rng = np.random.default_rng(4)
        n = 20
        tid = rng.integers(0, tables.shape[0], size=n, dtype=np.int32)
        ridx = rng.integers(0, 32, size=(n, 6), dtype=np.int32)
        rmask = (rng.random((n, 6)) < 0.6).astype(np.float32)
        port = teb.embedding_bag_rows(
            *map(torch.from_numpy, (tables, tid, ridx, rmask)))
        out = jeb.embedding_bag_rows(
            jnp.asarray(tables), jnp.asarray(tid), jnp.asarray(ridx),
            jnp.asarray(rmask), interpret=True)
        _close(port, out)
        _close(port, jref.embedding_bag_rows_ref(tables, tid, ridx, rmask))

    def test_single_table_matches_jax_ref(self):
        tables, idx, mask = _stack(5, hot=7)
        port = teb.embedding_bag(torch.from_numpy(tables[1]),
                                 torch.from_numpy(idx[:, 1]),
                                 torch.from_numpy(mask[:, 1]))
        _close(port, jref.embedding_bag_ref(tables[1], idx[:, 1],
                                            mask[:, 1]))

    def test_out_of_range_ids_clamp(self):
        tables, idx, mask = _stack(6, r=10, hot=4)
        wild = idx.copy()
        wild[:, :, 0] = -7
        wild[:, :, 1] = 10_000
        clamped = np.clip(wild, 0, tables.shape[1] - 1)
        port = teb.embedding_bag_stacked(
            *map(torch.from_numpy, (tables, wild, mask)))
        want = teb.embedding_bag_stacked(
            *map(torch.from_numpy, (tables, clamped, mask)))
        assert torch.equal(port, want)
        _close(port, jref.embedding_bag_stacked_ref(
            *map(jnp.asarray, (tables, wild, mask))))
        tid = np.array([-3, 0, 99], np.int32)
        rows = teb.embedding_bag_rows(
            torch.from_numpy(tables), torch.from_numpy(tid),
            torch.from_numpy(wild[:3, 0]), torch.from_numpy(mask[:3, 0]))
        _close(rows, jref.embedding_bag_rows_ref(
            *map(jnp.asarray, (tables, tid, wild[:3, 0], mask[:3, 0]))))

    def test_all_masked_bag_is_exact_zero(self):
        tables, idx, mask = _stack(7)
        mask[2] = 0.0
        mask[:, 1] = 0.0
        port = teb.embedding_bag_stacked(
            *map(torch.from_numpy, (tables, idx, mask)))
        assert torch.equal(port[2], torch.zeros_like(port[2]))
        assert torch.equal(port[:, 1], torch.zeros_like(port[:, 1]))

    @pytest.mark.parametrize("kw", [{"row_block": -2},
                                    {"pool_mode": "simd"}])
    def test_knobs_keep_the_reference_value_sets(self, kw):
        tables, idx, mask = _stack(8)
        with pytest.raises(ValueError):
            teb.embedding_bag_stacked(
                *map(torch.from_numpy, (tables, idx, mask)), **kw)

    @pytest.mark.parametrize("row_block,pool_mode",
                             [(-1, "scalar"), (0, "vector"), (8, "auto")])
    def test_knob_values_do_not_change_the_result(self, row_block,
                                                  pool_mode):
        tables, idx, mask = _stack(9)
        args = tuple(map(torch.from_numpy, (tables, idx, mask)))
        assert torch.equal(
            teb.embedding_bag_stacked(*args, row_block=row_block,
                                      pool_mode=pool_mode),
            teb.embedding_bag_stacked(*args))

    def test_plan_is_not_ported(self):
        tables, idx, mask = _stack(10)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            teb.embedding_bag_stacked(
                *map(torch.from_numpy, (tables, idx, mask)), plan=object())


class TestDotInteraction:
    @pytest.mark.parametrize("b,f,s", [(16, 9, 16), (7, 27, 64),
                                       (5, 24, 8), (3, 2, 4)])
    def test_matches_jax_kernel_interpret(self, b, f, s):
        # features at the model's scale (|z| well under 1), so the f32
        # rounding of a 64-term dot stays inside atol
        z = 0.25 * np.random.default_rng(b * f).standard_normal(
            (b, f, s), dtype=np.float32)
        port = tdot.dot_interaction(torch.from_numpy(z))
        assert port.shape == (b, f * (f - 1) // 2)
        _close(port, jdot.dot_interaction(jnp.asarray(z), batch_tile=4,
                                          interpret=True))
        _close(port, jref.dot_interaction_ref(z))

    def test_pair_order_is_tril_row_major(self):
        # small integers: every dot is exact, so the order is all that
        # can differ
        f = 6
        z = np.random.default_rng(0).integers(-3, 4, size=(2, f, 5)) \
            .astype(np.float32)
        out = tdot.dot_interaction(torch.from_numpy(z)).numpy()
        gram = np.einsum("bfs,bgs->bfg", z, z)
        ii, jj = np.tril_indices(f, -1)
        np.testing.assert_array_equal(out, gram[:, ii, jj])
        assert list(zip(ii[:4], jj[:4])) == [(1, 0), (2, 0), (2, 1), (3, 0)]


class TestDispatch:
    def test_pallas_on_cpu_raises(self):
        tables, idx, mask = _stack(11)
        args = tuple(map(torch.from_numpy, (tables, idx, mask)))
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.embedding_bag_stacked_op(*args, impl="pallas")
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.dot_interaction_op(torch.zeros(2, 3, 4), impl="pallas")

    def test_kernel_launchers_refuse_cpu_tensors(self):
        t = torch.zeros(8, 4)
        i = torch.zeros(2, 3, dtype=torch.int32)
        with pytest.raises(RuntimeError, match="CUDA"):
            teb.pool_rows(t, i, torch.zeros(2, 3), rows=8, n_tables=1)
        with pytest.raises(RuntimeError, match="CUDA"):
            tdot.interact(torch.zeros(2, 3, 4))
        assert teb.POOL.launches == 0 and tdot.DOT.launches == 0

    @pytest.mark.parametrize("impl", ["ref", "interpret", "auto"])
    def test_cpu_impls_take_the_plain_version(self, impl):
        tables, idx, mask = _stack(12)
        args = tuple(map(torch.from_numpy, (tables, idx, mask)))
        assert torch.equal(ops.embedding_bag_stacked_op(*args, impl=impl),
                           tref.embedding_bag_stacked_ref(*args))

    def test_unknown_impl_raises(self):
        with pytest.raises(ValueError):
            ops.dot_interaction_op(torch.zeros(2, 3, 4), impl="triton")

    def test_reset_launches(self):
        for k in ops.kernels().values():
            k.launches = 3
        ops.reset_launches()
        assert all(k.launches == 0 for k in ops.kernels().values())

    def test_kernel_argtypes_match_the_c_entry_points(self):
        # the C signatures: (table, idx, w, tid, out, n_bags, hot, s, rows,
        # n_tables, stream) and (z, out, batch, f, s, stream)
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        assert teb.POOL.argtypes == [p] * 5 + [i64, i, i, i64, i, p]
        assert tdot.DOT.argtypes == [p, p, i, i, i, p]
        for k in ops.kernels().values():
            src = (_build.CSRC / k.source).read_text()
            assert f'extern "C" int {k.symbol}(' in src
            assert "cudaGetLastError()" in src


class TestBuild:
    def test_build_targets_are_sm_90a_and_content_addressed(self):
        assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
        for src in _build.SOURCES:
            tgt = _build.target(src)
            assert tgt.parent == ROOT / "build" / "kernels"
            assert tgt.name.startswith(Path(src).stem + "-")

    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.nvcc()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
