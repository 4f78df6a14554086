"""Embedding-bag wrappers over the hand-written CUDA pooling kernel
(``csrc/embedding_bag.cu``), the port of ``repro/kernels/embedding_bag.py``.

All three entry points — :func:`embedding_bag` (one table),
:func:`embedding_bag_stacked` (the (T, R, s) model stack) and
:func:`embedding_bag_rows` (packed rows, each against its own table) —
address the stack as one flat (T·R, s) row space with global row id
t·R + clip(idx), and go through the one kernel, :func:`pool_rows`.

For CPU tensors the wrappers take the plain versions in ``kernels/ref.py``;
for CUDA tensors they launch the kernel or raise.  ``row_block`` and
``pool_mode`` keep the reference's value sets and are validated, but they
shaped a TPU VMEM/DMA schedule that has no counterpart here: the kernel
reads each row straight from device memory whatever their value.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import Kernel

POOL = Kernel("embedding_bag.cu", "embedding_bag_pool_f32",
              [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int64,
                                       ctypes.c_int, ctypes.c_void_p])


def launch_key(n_bags: int, hot: int, s: int, n_tables: int,
               rows_form: bool = False) -> tuple:
    """What ``POOL.by_key`` counts a launch under: its bags, slots per bag,
    width, tables and whether it is the rows form."""
    return (n_bags, hot, s, n_tables, rows_form)


def launch_plan(n_bags: int, hot: int, s: int, n_tables: int, *,
                rows_form: bool = False) -> dict:
    """The plan the CUDA launcher picks for a call of these shapes on the
    current card (it reads the card's SM count, so it needs one): lanes
    per row, groups per bag (``ref.embedding_bag_split_ref``'s
    ``groups``), whether the schedule is table-major, blocks and bytes of
    dynamic shared memory."""
    fn = _build.library("embedding_bag.cu").embedding_bag_plan
    fn.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int64 * 5)()
    err = fn(n_bags, hot, s, n_tables, int(rows_form), out)
    if err:
        raise RuntimeError(f"embedding_bag_plan: CUDA error {err}")
    return dict(zip(("lanes", "groups", "table_major", "blocks", "smem"),
                    map(int, out)))


def resolve_row_block(row_block: int) -> int:
    """Validate the reference's knob: -1 resident, 0 auto, > 0 streamed."""
    if row_block < -1:
        raise ValueError(f"row_block must be -1, 0 or positive, "
                         f"got {row_block}")
    return row_block


def resolve_pool_mode(pool_mode: str) -> str:
    """'auto' -> 'vector', as in the reference; 'scalar' and 'vector' are
    the TPU's two pooling loops, both served by the one CUDA kernel."""
    if pool_mode == "auto":
        return "vector"
    if pool_mode not in ("scalar", "vector"):
        raise ValueError(f"pool_mode must be 'scalar', 'vector' or 'auto', "
                         f"got {pool_mode!r}")
    return pool_mode


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"embedding bags run on 'cpu' or 'cuda' tensors, "
                     f"got {t.device}")


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pool_rows(table_flat, idx, w, *, rows: int, n_tables: int, tid=None):
    """The CUDA kernel: table_flat (n_tables·rows, s) float32, idx (N, hot)
    int32, w (N, hot) float32 and optionally tid (N,) int32 -> (N, s).
    Bag n pools against table tid[n], or n % n_tables without tid; ids are
    clamped to [0, rows-1] and table ids to [0, n_tables-1] in the kernel.
    Raises for anything but contiguous CUDA tensors of those types."""
    dev = table_flat.device
    if dev.type != "cuda":
        raise RuntimeError(f"pool_rows launches a CUDA kernel; got a tensor "
                           f"on {dev}")
    if table_flat.dtype != torch.float32:
        raise NotImplementedError(
            f"the CUDA bag kernel takes float32 tables, got "
            f"{table_flat.dtype} (bf16 tables: ROADMAP B-section)")
    n, hot = idx.shape
    s = table_flat.shape[1]
    _check("table_flat", table_flat, torch.float32, (n_tables * rows, s),
           dev)
    _check("idx", idx, torch.int32, (n, hot), dev)
    _check("w", w, torch.float32, (n, hot), dev)
    if tid is not None:
        _check("tid", tid, torch.int32, (n,), dev)
    if rows < 1 or n_tables < 1:
        raise ValueError(f"empty table stack ({n_tables} x {rows} rows)")
    if table_flat.data_ptr() % 16:
        raise ValueError("table_flat must be 16-byte aligned")
    out = torch.empty((n, s), dtype=torch.float32, device=dev)
    if n == 0 or s == 0:
        return out
    with torch.cuda.device(dev):
        POOL(table_flat.data_ptr(), idx.data_ptr(), w.data_ptr(),
             None if tid is None else tid.data_ptr(), out.data_ptr(),
             n, hot, s, rows, n_tables,
             torch.cuda.current_stream(dev).cuda_stream,
             key=launch_key(n, hot, s, n_tables, tid is not None))
    return out


def _flat(tables):
    """(T, R, s) -> the (T·R, s) row space, as a view: a stack that is not
    contiguous raises here rather than being copied whole."""
    t, r, s = tables.shape
    return tables.view(t * r, s)


def _ids(idx):
    return idx.to(torch.int32).contiguous()


def _weights(mask):
    return mask.to(torch.float32).contiguous()


def _no_plan(plan):
    if plan is not None:
        raise NotImplementedError(
            "plan= (precomputed StreamPlans) is not ported: ROADMAP "
            "'StreamPlan builders and plan_pipeline'")


def embedding_bag(table, idx, mask, *, batch_tile: int = 64,
                  row_block: int = 0, pool_mode: str = "auto", plan=None):
    """table:(R,S) idx:(B,hot) mask:(B,hot) -> (B,S).  ``batch_tile`` is
    the TPU grid tile and has no counterpart (the kernel plans its own
    grid)."""
    resolve_row_block(row_block)
    resolve_pool_mode(pool_mode)
    _no_plan(plan)
    if _on_cpu(table):
        return ref.embedding_bag_ref(table, idx, mask)
    r, _ = table.shape
    return pool_rows(table, _ids(idx), _weights(mask), rows=r, n_tables=1)


def embedding_bag_stacked(tables, idx, mask, *, batch_tile: int = 64,
                          row_block: int = 0, pool_mode: str = "auto",
                          plan=None):
    """tables:(T,R,s) idx:(B,T,hot) mask:(B,T,hot) -> (B,T,s), the
    model-facing form of ``apply_emb``.  Bag (b, t) is row b·T + t of the
    flattened index list, so its table is that row's index mod T."""
    resolve_row_block(row_block)
    resolve_pool_mode(pool_mode)
    _no_plan(plan)
    t, r, s = tables.shape
    b, t2, hot = idx.shape
    if t != t2:
        raise ValueError(f"idx covers {t2} tables, the stack has {t}")
    if _on_cpu(tables):
        return ref.embedding_bag_stacked_ref(tables, idx, mask)
    out = pool_rows(_flat(tables), _ids(idx).reshape(b * t, hot),
                    _weights(mask).reshape(b * t, hot), rows=r, n_tables=t)
    return out.reshape(b, t, s)


def embedding_bag_rows(tables, tid, idx, mask, *, row_tile: int = 64,
                       row_block: int = 0, pool_mode: str = "auto"):
    """tables:(T,R,s) tid:(N,) idx/mask:(N,hot) -> (N,s) masked sums, each
    row pooled against its own table (the pool half of the ragged
    exchange)."""
    resolve_row_block(row_block)
    resolve_pool_mode(pool_mode)
    t, r, _ = tables.shape
    if _on_cpu(tables):
        return ref.embedding_bag_rows_ref(tables, tid, idx, mask)
    return pool_rows(_flat(tables), _ids(idx), _weights(mask),
                     rows=r, n_tables=t, tid=_ids(tid))
