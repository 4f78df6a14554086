"""Serving engines (the port of the core of ``repro/serving/engine.py``):
``DLRMEngine`` for CTRs and ``LMEngine`` for greedy LM decoding.

CTR requests (dense, sparse) accumulate into fixed-size batches; each flush
runs the BLS forward over microbatches on the model group and returns
``sigmoid(logits)``; per-batch latency feeds the straggler monitor whose
recommendation can retune the bound between batches.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import DLRMConfig, ModelConfig
from repro_torch.core import alltoallv as a2a_mod
from repro_torch.core import bls as bls_mod
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import api
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.train import steps as steps_mod


@dataclasses.dataclass
class ServeStats:
    batches: int = 0
    requests: int = 0
    total_s: float = 0.0

    @property
    def throughput_rps(self) -> float:
        return self.requests / self.total_s if self.total_s else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["throughput_rps"] = self.throughput_rps
        return d


class DLRMEngine:
    """Fixed-batch CTR serving with the BLS-enabled forward.

    ``wire_dtype``, ``exchange``, ``exchange_pipeline``, ``row_block`` and
    ``pool_mode`` default to the config's and must stay on the ported slice
    (float32 wire, dense exchange, mono pipeline).  ``device`` is where the
    batches go and the parameters must live; ``group`` the model group
    (default: the one ``launch/mesh.py`` set up, or single-device without
    one).  The reference's cache, plan pipeline, chaos, freshness,
    resharding and scrubbing options raise ``NotImplementedError``."""

    def __init__(self, params, cfg: DLRMConfig, *, batch_size: int = 512,
                 bound: int = 0, microbatches: int = 1,
                 wire_dtype: Optional[str] = None,
                 exchange: Optional[str] = None,
                 exchange_pipeline: Optional[str] = None,
                 row_block: Optional[int] = None,
                 pool_mode: Optional[str] = None,
                 device="cuda", group=None, cache=None,
                 plan_pipeline: bool = False, faults=None, freshness=None,
                 rebalance: bool = False, scrub_budget: int = 0):
        self.device = resolve_device(device)
        unported = {"plan_pipeline": plan_pipeline, "faults": faults,
                    "freshness": freshness, "rebalance": rebalance,
                    "scrub_budget": scrub_budget}
        for name, val in unported.items():
            if val:
                raise NotImplementedError(
                    f"DLRMEngine({name}=...) is not ported yet (ROADMAP "
                    "'StreamPlan builders and plan_pipeline', A8-A12)")
        self.params, self.cfg = params, cfg
        if params["tables"].device != self.device:
            raise ValueError(f"parameters are on {params['tables'].device}, "
                             f"the engine serves on {self.device}")
        self.wire_dtype = dlrm_mod.resolve_slice(
            cfg, cache=cache, wire_dtype=wire_dtype, exchange=exchange,
            exchange_pipeline=exchange_pipeline)
        self.exchange = exchange or cfg.exchange
        self.exchange_pipeline = exchange_pipeline or cfg.exchange_pipeline
        self.row_block = row_block if row_block is not None \
            else cfg.row_block
        self.pool_mode = pool_mode if pool_mode is not None \
            else cfg.pool_mode
        self.batch_size = batch_size
        self.bound, self.microbatches = int(bound), microbatches
        self.group = group
        self.monitor = StragglerMonitor()
        self.stats = ServeStats()
        self._pending: list = []
        self._last_finish_t = 0.0

    def _group(self):
        return self.group if self.group is not None \
            else mesh_mod.current_group()

    def submit(self, dense: np.ndarray, idx: np.ndarray, mask: np.ndarray):
        """Queue one request (row).  Returns CTRs when a batch fills."""
        self._pending.append((dense, idx, mask))
        if len(self._pending) >= self.batch_size:
            return self.flush()
        return None

    def flush(self):
        """Run the pending batch (padded with copies of its last request)
        and return its CTRs, or None when nothing is pending."""
        if not self._pending:
            return None
        n = len(self._pending)
        pad = self.batch_size - n
        d = np.stack([p[0] for p in self._pending] +
                     [self._pending[-1][0]] * pad)
        i = np.stack([p[1] for p in self._pending] +
                     [self._pending[-1][1]] * pad)
        m = np.stack([p[2] for p in self._pending] +
                     [self._pending[-1][2]] * pad)
        self._pending.clear()
        t0 = time.perf_counter()
        d, i, m = self._fit_batch(d, i, m)
        dev = self.device
        with torch.no_grad():
            logits = dlrm_mod.forward_distributed(
                self.params, self.cfg, torch.from_numpy(d).to(dev),
                torch.from_numpy(i).to(dev), torch.from_numpy(m).to(dev),
                bound=self.bound, microbatches=self.microbatches,
                wire_dtype=self.wire_dtype, exchange=self.exchange,
                exchange_pipeline=self.exchange_pipeline,
                row_block=self.row_block, pool_mode=self.pool_mode,
                group=self._group())
            out = torch.sigmoid(logits).cpu().numpy()   # waits for the card
        end = time.perf_counter()
        self.monitor.observe(end - t0)
        self.stats.batches += 1
        self.stats.requests += n
        self.stats.total_s += end - max(t0, self._last_finish_t)
        self._last_finish_t = max(self._last_finish_t, end)
        return out[:n]

    def drain(self):
        """Flush whatever is pending: its CTRs, or None when nothing is
        outstanding (idempotent)."""
        return self.flush()

    def _fit_batch(self, d, i, m):
        """Re-fit the sparse tensors to the group's table padding:
        t_pad = padded_tables(cfg, P).  Padding tables carry mask 0 and are
        never indexed, so cropping or zero-padding them is exact."""
        _, t_pad, _, _ = self._exchange_geometry()
        have = i.shape[1]
        if have > t_pad:
            i, m = i[:, :t_pad], m[:, :t_pad]
        elif have < t_pad:
            iz = np.zeros((i.shape[0], t_pad - have, i.shape[2]), i.dtype)
            mz = np.zeros((m.shape[0], t_pad - have, m.shape[2]), m.dtype)
            i = np.concatenate([i, iz], axis=1)
            m = np.concatenate([m, mz], axis=1)
        return d, i, m

    def _exchange_geometry(self):
        """(P, t_pad, bs, dense_rows): bs is the per-(member, microbatch)
        batch slice and dense_rows = bs·t_loc what the exchange moves per
        destination."""
        group = self._group()
        p = dist.get_world_size(group) if group is not None else 1
        t_pad = dlrm_mod.padded_tables(self.cfg, p)
        bs = max(1, self.batch_size // (self.microbatches * p))
        return p, t_pad, bs, bs * (t_pad // p)

    def set_bound(self, bound: int):
        """Adopt a new BLS bound from the next flush on."""
        self.bound = int(bound)

    def slot_bytes(self) -> int:
        """Bytes ONE BLS ring slot buffers: the fused (P, slot_bytes) uint8
        receive buffer plus the buffered bottom-MLP activations."""
        p, t_pad, bs, _ = self._exchange_geometry()
        s = self.cfg.embed_dim
        layout = a2a_mod.exchange_wire_layout(
            ragged=False, n_dest=p, cap=0, bs=bs, t_loc=t_pad // p,
            embed_dim=s, wire_dtype=self.wire_dtype,
            emb_dtype=self.params["tables"].dtype)
        recv = torch.empty((p, layout.slot_bytes), dtype=torch.uint8,
                           device="meta")
        side = torch.empty((bs, s), dtype=L.dtype_of(self.cfg.dtype),
                           device="meta")
        return bls_mod.ring_slot_bytes(recv, [side])

    def recommend_bound(self, memory_budget: int = 64 << 20):
        """Memory-budget -> bound recommendation, sized by
        :meth:`slot_bytes`."""
        return self.monitor.recommend_bound(slot_bytes=self.slot_bytes(),
                                            memory_budget=memory_budget)


class LMEngine:
    """Batched greedy decoding for the LM families the port runs: the dense
    family prefills the prompts into a cache of ``max_len`` positions, the
    recurrent one (rwkv6) consumes them token by token through
    ``decode_step``, as the reference does; then one serve step per token,
    each step's latency observed by the straggler monitor."""

    def __init__(self, params, cfg: ModelConfig, *, max_len: int = 256,
                 device="cuda"):
        api.check_ported(cfg)
        self.device = resolve_device(device)
        leaf = params["embed"]["table"]
        if leaf.device != self.device:
            raise ValueError(f"parameters are on {leaf.device}, the engine "
                             f"serves on {self.device}")
        self.params, self.cfg, self.max_len = params, cfg, max_len
        self._serve = steps_mod.make_serve_step(cfg)
        self.monitor = StragglerMonitor()

    def generate(self, prompts: np.ndarray, n_tokens: int) -> np.ndarray:
        """prompts: (B, P) int32 -> (B, n_tokens) greedy continuation.  As
        in the reference, the first serve step feeds the prompt's last token
        again, at position P.  A step's latency ends when its tokens reach
        the host."""
        dev = self.device
        b, p = prompts.shape
        with torch.no_grad():
            if self.cfg.family in ("dense", "moe", "vlm"):
                _, cache = T.prefill(self.params, self.cfg,
                                     torch.from_numpy(prompts).to(dev),
                                     pad_to=self.max_len)
            else:
                cache = api.make_cache(self.cfg, b, self.max_len, device=dev)
                toks = torch.from_numpy(prompts).to(dev)
                for t in range(p):
                    _, cache = api.decode_step(self.params, self.cfg,
                                               toks[:, t:t + 1], cache)
        tok = torch.from_numpy(np.ascontiguousarray(prompts[:, -1:])).to(dev)
        outs = []
        for _ in range(n_tokens):
            t0 = time.perf_counter()
            tok, cache = self._serve(self.params, tok, cache)
            host = tok.cpu().numpy()
            self.monitor.observe(time.perf_counter() - t0)
            outs.append(host)
        return np.concatenate(outs, axis=1)
