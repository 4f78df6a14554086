"""Serving engines (the port of the core of ``repro/serving/engine.py``):
``DLRMEngine`` for CTRs and ``LMEngine`` for greedy LM decoding.

CTR requests (dense, sparse) accumulate into fixed-size batches; each flush
runs the BLS forward over microbatches on the model group and returns
``sigmoid(logits)``; per-batch latency feeds the straggler monitor whose
recommendation can retune the bound between batches, and the exchange's
live-row counts feed the cap autotuner that moves an ``exchange='auto'``
engine with a hot-row cache onto the ragged exchange.
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
from repro_torch.runtime.straggler import CapAutotuner, StragglerMonitor
from repro_torch.serving import hot_cache as hc_mod
from repro_torch.train import steps as steps_mod


@dataclasses.dataclass
class ServeStats:
    batches: int = 0
    requests: int = 0
    total_s: float = 0.0
    retunes: int = 0          # caps the autotuner adopted

    @property
    def throughput_rps(self) -> float:
        return self.requests / self.total_s if self.total_s else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["throughput_rps"] = self.throughput_rps
        return d


class DLRMEngine:
    """Fixed-batch CTR serving with the BLS-enabled forward.

    ``wire_dtype``, ``exchange``, ``ragged_cap``, ``exchange_pipeline``,
    ``row_block`` and ``pool_mode`` default to the config's.  ``cache`` (a
    ``serving/hot_cache.HotCache`` over the full table stack) or one built
    by :meth:`calibrate_cache` moves the skewed head of the traffic off the
    wire.  Under ``exchange='auto'`` with a cache every flush feeds the
    exchange's live-count and drop diagnostics to a ``CapAutotuner``, and
    every ``retune_every`` batches :meth:`retune_cap` adopts its cap, which
    moves the engine between the dense and the ragged exchange; the port
    has no jit, so a retune takes effect at the next flush.  ``device`` is
    where the batches go and the parameters must live; ``group`` the model
    group (default: the one ``launch/mesh.py`` set up, or single-device
    without one).  The reference's plan pipeline, chaos, freshness,
    resharding and scrubbing options raise ``NotImplementedError``."""

    def __init__(self, params, cfg: DLRMConfig, *, batch_size: int = 512,
                 bound: int = 0, microbatches: int = 1,
                 wire_dtype: Optional[str] = None, cache=None,
                 exchange: Optional[str] = None,
                 ragged_cap: Optional[int] = None,
                 exchange_pipeline: Optional[str] = None,
                 retune_every: int = 8,
                 row_block: Optional[int] = None,
                 pool_mode: Optional[str] = None,
                 device="cuda", group=None,
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
            cfg, wire_dtype=wire_dtype, exchange=exchange,
            exchange_pipeline=exchange_pipeline)
        self.cache = cache
        self.exchange = exchange or cfg.exchange
        self.ragged_cap = ragged_cap if ragged_cap is not None \
            else cfg.ragged_cap
        self.exchange_pipeline = exchange_pipeline or cfg.exchange_pipeline
        self.retune_every = retune_every
        self.row_block = row_block if row_block is not None \
            else cfg.row_block
        self.pool_mode = pool_mode if pool_mode is not None \
            else cfg.pool_mode
        self.batch_size = batch_size
        self.bound, self.microbatches = int(bound), microbatches
        self.group = group
        self.monitor = StragglerMonitor()
        self.cap_tuner = CapAutotuner()
        self.stats = ServeStats()
        self._pending: list = []
        self._last_finish_t = 0.0

    def calibrate_cache(self, idx: np.ndarray, mask: np.ndarray,
                        cache_rows: Optional[int] = None):
        """Build the hot-row cache from an observed (idx, mask) sample;
        ``cache_rows`` defaults to cfg.cache_rows."""
        rows = cache_rows if cache_rows is not None else self.cfg.cache_rows
        self.cache = hc_mod.build_from_batch(self.params["tables"], idx,
                                             mask, rows)
        return self.cache

    def adopt_cache(self, cache):
        """Swap in an externally built hot-row cache (None drops it)."""
        self.cache = cache

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
        # the diagnostics cost a re-probe of the misses and two small
        # collectives: only when something reads them (drop monitoring under
        # 'ragged', the autotuner under 'auto' with a cache)
        diag_on = self.exchange == "ragged" or (
            self.exchange == "auto" and self.cache is not None)
        with torch.no_grad():
            res = dlrm_mod.forward_distributed(
                self.params, self.cfg, torch.from_numpy(d).to(dev),
                torch.from_numpy(i).to(dev), torch.from_numpy(m).to(dev),
                bound=self.bound, microbatches=self.microbatches,
                cache=self.cache, wire_dtype=self.wire_dtype,
                exchange=self.exchange, ragged_cap=self.ragged_cap,
                exchange_pipeline=self.exchange_pipeline,
                row_block=self.row_block, pool_mode=self.pool_mode,
                return_diag=diag_on, group=self._group())
            logits, diag = res if diag_on else (res, None)
            out = torch.sigmoid(logits).cpu().numpy()   # waits for the card
        end = time.perf_counter()
        self.monitor.observe(end - t0)
        if diag is not None:
            self.cap_tuner.observe(int(diag.live_max), int(diag.drops))
        self.stats.batches += 1
        self.stats.requests += n
        self.stats.total_s += end - max(t0, self._last_finish_t)
        self._last_finish_t = max(self._last_finish_t, end)
        if self.exchange == "auto" and \
                self.stats.batches % self.retune_every == 0:
            self.retune_cap()
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

    def retune_cap(self):
        """Under ``exchange='auto'``: adopt the autotuner's cap: growth
        (drops seen, or the live tail drifted up) at once, a shrink only
        past 25%.  Each adoption counts in ``stats.retunes`` and serves
        from the next flush.  Under a forced exchange this only reads a
        peeked recommendation.  Returns the recommendation, or None before
        any observation."""
        if not len(self.cap_tuner):
            return None
        _, _, _, dense_rows = self._exchange_geometry()
        cur = self.ragged_cap or dense_rows
        rec = self.cap_tuner.recommend(dense_rows=dense_rows,
                                       current_cap=self.ragged_cap or None,
                                       peek=self.exchange != "auto")
        if self.exchange != "auto":
            return rec
        grow = rec.cap > cur
        shrink = rec.cap * 4 <= cur * 3
        if grow or shrink:
            self.ragged_cap = rec.cap
            self.stats.retunes += 1
        return rec

    def slot_bytes(self) -> int:
        """Bytes ONE BLS ring slot buffers: the fused (P, slot_bytes) uint8
        buffer of the exchange the engine resolves to (dense or ragged, at
        its codec), the buffered bottom-MLP activations and, with a cache,
        the (bs, t_pad, s) pooled hits."""
        p, t_pad, bs, dense_rows = self._exchange_geometry()
        s = self.cfg.embed_dim
        emb_dtype = self.params["tables"].dtype
        use_cache = self.cache is not None and self.cache.cache_rows > 0
        use_ragged, cap = dlrm_mod.resolve_exchange(
            self.exchange, use_cache=use_cache, cap=self.ragged_cap,
            dense_rows=dense_rows)
        layout = a2a_mod.exchange_wire_layout(
            ragged=use_ragged, n_dest=p, cap=cap, bs=bs, t_loc=t_pad // p,
            embed_dim=s, wire_dtype=self.wire_dtype, emb_dtype=emb_dtype)
        recv = torch.empty((p, layout.slot_bytes), dtype=torch.uint8,
                           device="meta")
        side = [torch.empty((bs, s), dtype=L.dtype_of(self.cfg.dtype),
                            device="meta")]
        if use_cache:
            side.append(torch.empty((bs, t_pad, s), dtype=emb_dtype,
                                    device="meta"))
        return bls_mod.ring_slot_bytes(recv, side)

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
