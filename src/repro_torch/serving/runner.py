"""Model runner: device dispatch for the serving engine (PyTorch port of
`repro.serving.runner`).

The bottom layer of the engine (scheduler -> block manager -> runner). It
owns everything that touches the device: the paged KV pools, the device
mirror of the block tables and the prefill / decode / verify / block-copy
dispatches. It knows nothing about queues, refcounts, or request
lifecycle — the scheduler hands it fully-resolved work and gets tokens
back.

Dispatch is eager PyTorch over the same bucket grid as the JAX runner:
queued prompts are padded to power-of-two suffix-length buckets (batch
width bucketed too, padded with inert rows that write only the null
block), and verify chains to power-of-two chain buckets. The padding
decides the numerics, so the grid is kept even though nothing compiles
per shape here; `prefill_shapes` / `verify_shapes` and the telemetry's
`first_dispatch` flag still record the distinct shapes. Capturing CUDA
graphs per bucket is a later change.

Speculative verify: `verify()` keeps the recurrent layers' per-step
snapshots, and `commit()` restores each lane's recurrent slot state at its
accepted length from them (attention needs no commit: stale K/V past the
accepted point is position-masked until overwritten).

One difference from the JAX runner: `decode()` takes the scheduler's
active lanes and hands them to `lm.decode_step_paged`, so a lane that
sits the step out (mid-way through a chunked prefill) keeps its recurrent
state. The JAX step advances every slot's state, and a chunked prompt's
next chunk then resumes from the corrupted state.

Per-request sampling configs are DATA: temperature / top-k / top-p / seed
ride through every dispatch as (num_slots,) tensors, mirrored to the
device lazily as the block tables are. A dispatch takes the argmax fast
path unless a live slot samples (`sampled_dispatches` counts the others);
randomness is position-keyed per request (serving/sampling.py), so the
runner holds no sampler state.

Pools and slot state are updated in place (the JAX runner donates them),
in the activation dtype or quantized (kv_dtype "int8" / "fp8", with scale
tables). The host spill tier moves block payloads through `fetch_block`
(device -> host, one block) and `upload_blocks` (host -> device, padded to
a `promote_buckets` width as the JAX runner pads its jitted scatter).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, to_device
from repro_torch.models import lm
from repro_torch.serving import kv_cache, sampling
from repro_torch.serving.block_manager import NULL_BLOCK
from repro_torch.serving.bucketing import (chain_buckets, next_pow2,
                                           normalize_buckets, pick_bucket,
                                           pow2_buckets, width_buckets)
from repro_torch.serving.observability import NULL_OBS, Observability
from repro_torch.serving.sampling import GREEDY, SamplingParams

# default chunked-prefill budget (tokens per prefill dispatch); prompts
# whose suffix exceeds the largest prefill bucket are split into chunks
# of at most this size — see ModelRunner(prefill_chunk=...)
DEFAULT_PREFILL_CHUNK = 2048


@dataclasses.dataclass
class PrefillRow:
    """One sequence of a prefill batch, fully resolved by the scheduler:
    suffix tokens to compute, how much of the prompt is cache-hit, the
    request's sampling config, and where the results land."""
    tokens: np.ndarray          # (P,) the FULL prompt, int32
    cached_len: int             # prompt tokens already present in blocks
    slot: int                   # decode lane (recurrent state index)
    table_row: np.ndarray       # (max_blocks,) int32, NULL padded
    sampling: SamplingParams = GREEDY

    @property
    def start(self) -> int:     # first computed position
        return min(self.cached_len, len(self.tokens) - 1)

    @property
    def suffix_len(self) -> int:
        return len(self.tokens) - self.start


class ModelRunner:
    """Owns device state + eager dispatch. See module docstring."""

    def __init__(self, params, cfg: ModelConfig, *, num_slots: int,
                 block_size: int, num_blocks: int, max_blocks_per_seq: int,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 prefill_max_batch: int = 4,
                 prefill_chunk: Optional[int] = None, speculate: int = 0,
                 max_logprobs: int = 8, kv_dtype: str = "fp16",
                 obs: Observability = NULL_OBS,
                 now_fn: Optional[Callable[[], float]] = None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self._obs = obs or NULL_OBS
        self._now = now_fn or (lambda: 0.0)
        self._c_prefill = self._obs.counter("prefill_dispatches_total")
        self._c_decode = self._obs.counter("decode_dispatches_total")
        self._c_verify = self._obs.counter("verify_dispatches_total")
        self._c_copies = self._obs.counter("block_copies_total")
        # distinct dispatch variants seen (the trace's first_dispatch flag)
        self._prefill_variants: set = set()
        self._decode_variants: set = set()
        self._verify_variants: set = set()
        self.num_slots = num_slots
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.kv_dtype = kv_dtype
        # params moved and cast to the compute dtype once, so the lm
        # functions' own cast_params is free on every dispatch
        self.params = lm.cast_params(to_device(params, self.device), cfg)
        self.state = kv_cache.init_paged_state(cfg, num_slots, num_blocks,
                                               block_size, kv_dtype,
                                               device=self.device)
        self.cache_bytes = kv_cache.paged_bytes(cfg, num_blocks, block_size,
                                                kv_dtype)
        self.block_bytes = kv_cache.block_bytes(cfg, block_size, kv_dtype)

        max_len = max_blocks_per_seq * block_size
        self.prefill_buckets = normalize_buckets(
            prefill_buckets, max_len, start=min(16, next_pow2(max_len)))
        # chunked prefill budget, exactly as the JAX runner: None = auto
        # (DEFAULT_PREFILL_CHUNK capped to the grid), 0 = disabled
        if prefill_chunk is None:
            prefill_chunk = DEFAULT_PREFILL_CHUNK
        if prefill_chunk:
            budget = pick_bucket(min(prefill_chunk, max_len),
                                 self.prefill_buckets)
            self.prefill_buckets = [b for b in self.prefill_buckets
                                    if b <= budget]
            self.prefill_chunk = budget
        else:
            self.prefill_chunk = 0
            if prefill_buckets:
                self.prefill_buckets = sorted(
                    set(int(b) for b in prefill_buckets))
        self.prefill_max_batch = max(1, prefill_max_batch)
        self.width_buckets = width_buckets(self.prefill_max_batch)
        self.speculate = max(0, speculate)
        self.verify_buckets = chain_buckets(self.speculate)

        # host tables + device mirror (refreshed lazily when dirty)
        self._tables = np.zeros((num_slots, max_blocks_per_seq), np.int32)
        self._tables_dev = self._dev(self._tables)
        self._tables_dirty = False
        # per-slot sampling configs, the same pattern as the tables: host
        # arrays of plain data, mirrored to the device lazily
        self._temps = np.zeros(num_slots, np.float32)
        self._topks = np.zeros(num_slots, np.int32)
        self._topps = np.ones(num_slots, np.float32)
        self._seeds = np.zeros(num_slots, np.int32)
        self._wantk = np.zeros(num_slots, np.int32)   # requested logprob k
        self._sampling_dev = None
        self.max_logprobs = max(1, min(max_logprobs, cfg.vocab_size))
        # host-tier promotions pad to these widths (`promote_shapes`
        # records the widths dispatched)
        self.promote_buckets = pow2_buckets(max_blocks_per_seq)
        self.promote_shapes: set = set()

        self.prefill_shapes: set = set()     # distinct (width, Ls) dispatched
        self.verify_shapes: set = set()      # distinct chain buckets T
        self._snaps = None                   # pending recurrent snapshots
        self.reset_stats()

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def reset_stats(self) -> None:
        self.prefill_dispatches = 0
        self.prefill_padded_tokens = 0       # token slots incl. padding
        self.prefill_computed_tokens = 0     # true suffix tokens computed
        self.prefill_peak_score_bytes = 0    # analytic peak f32 score tile
        self.block_copies = 0
        self.verify_dispatches = 0
        self.verify_padded_tokens = 0        # chain slots incl. padding
        self.verify_chain_tokens = 0         # true chain tokens verified
        self.sampled_dispatches = 0          # decode/verify full-sampler uses

    # ------------------------------------------------------------------
    # block tables
    # ------------------------------------------------------------------

    def write_table(self, slot: int, row: np.ndarray) -> None:
        self._tables[slot] = row
        self._tables_dirty = True

    def clear_table(self, slot: int) -> None:
        self._tables[slot] = NULL_BLOCK
        self._tables_dirty = True
        self.clear_sampling(slot)

    def _tables_device(self):
        if self._tables_dirty:
            self._tables_dev = self._dev(self._tables)
            self._tables_dirty = False
        return self._tables_dev

    # ------------------------------------------------------------------
    # per-slot sampling configs
    # ------------------------------------------------------------------

    def set_sampling(self, slot: int, sp: SamplingParams) -> None:
        self._temps[slot] = sp.temperature
        self._topks[slot] = sp.top_k
        self._topps[slot] = sp.top_p
        self._seeds[slot] = sampling.seed32(sp.seed)
        self._wantk[slot] = min(sp.logprobs, self.max_logprobs)
        self._sampling_dev = None

    def clear_sampling(self, slot: int) -> None:
        self._temps[slot] = 0.0
        self._topks[slot] = 0
        self._topps[slot] = 1.0
        self._seeds[slot] = 0
        self._wantk[slot] = 0
        self._sampling_dev = None

    @property
    def any_sampled(self) -> bool:
        return bool(self._temps.max() > 0.0)

    @property
    def any_alt(self) -> bool:
        return bool(self._wantk.max() > 0)

    def _sampling_device(self):
        if self._sampling_dev is None:
            self._sampling_dev = tuple(self._dev(a) for a in (
                self._temps, self._topks, self._topps, self._seeds))
        return self._sampling_dev

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------

    def suffix_bucket(self, n: int) -> int:
        """Smallest configured length bucket covering n suffix tokens
        (an oversized suffix must have gone to chunked admission)."""
        if n > self.prefill_buckets[-1]:
            raise ValueError(
                f"prompt suffix of {n} tokens exceeds the largest "
                f"prefill bucket ({self.prefill_buckets[-1]}) and "
                f"chunked prefill is disabled (prefill_chunk=0); enable "
                f"chunked admission (prefill_chunk > 0, serve.py "
                f"--prefill-chunk) or widen --prefill-buckets")
        return pick_bucket(n, self.prefill_buckets)

    def chain_bucket(self, n: int) -> int:
        """Smallest verify bucket covering an n-token draft chain."""
        return pick_bucket(n, self.verify_buckets)

    def _host_out(self, tok, lp, alt_logits, n: Optional[int] = None):
        """Device results -> host numpy, with the top-max_logprobs
        alternatives when `alt_logits` is given."""
        alt = None
        if alt_logits is not None:
            ids, lps = sampling.top_alternatives(alt_logits,
                                                 self.max_logprobs)
            alt = (ids.cpu().numpy()[:n], lps.cpu().numpy()[:n])
        return tok.cpu().numpy()[:n], lp.cpu().numpy()[:n], alt

    @torch.inference_mode()
    def prefill(self, rows: List[PrefillRow], *, resume: bool = False,
                chunk: Optional[Tuple[int, int]] = None):
        """Run one bucketed batched prefill and sample each row's first
        token from its true-last-position logits with the row's own
        SamplingParams (position-keyed on the last prompt position).
        Blocks until done (the caller's TTFT clock covers it). Returns
        ((len(rows),) int32 tokens, (len(rows),) float32 logprobs, alt)
        where alt is None unless a row asked for logprobs. `resume` /
        `chunk` as in the JAX runner (chunk is recorded on the trace)."""
        n = len(rows)
        obs = self._obs
        t0 = self._now() if obs.enabled else 0.0
        ls = self.suffix_bucket(max(r.suffix_len for r in rows))
        width = pick_bucket(n, self.width_buckets)
        toks = np.zeros((width, ls), np.int32)
        lengths = np.zeros(width, np.int32)
        cached = np.zeros(width, np.int32)
        tables = np.full((width, self.max_blocks_per_seq), NULL_BLOCK,
                         np.int32)
        slots = np.full(width, self.num_slots, np.int32)   # pad rows drop
        temps = np.zeros(width, np.float32)
        topks = np.zeros(width, np.int32)
        topps = np.ones(width, np.float32)
        seeds = np.zeros(width, np.int32)
        for i, r in enumerate(rows):
            suf = r.tokens[r.start:]
            toks[i, :len(suf)] = suf
            lengths[i] = len(r.tokens)
            cached[i] = r.cached_len
            tables[i] = r.table_row
            slots[i] = r.slot
            temps[i] = r.sampling.temperature
            topks[i] = r.sampling.top_k
            topps[i] = r.sampling.top_p
            seeds[i] = sampling.seed32(r.sampling.seed)
        self.prefill_shapes.add((width, ls))
        self.prefill_dispatches += 1
        self.prefill_padded_tokens += width * ls
        self.prefill_computed_tokens += sum(r.suffix_len for r in rows)
        # analytic peak attention-score bytes of the JAX streamed path
        # (kept so the telemetry record has the same fields)
        kv_band = min(self.max_blocks_per_seq * self.block_size,
                      self.cfg.attn_chunk)
        score_bytes = 4 * width * self.cfg.n_heads * ls * (kv_band + ls)
        self.prefill_peak_score_bytes = max(self.prefill_peak_score_bytes,
                                            score_bytes)

        last, self.state = lm.prefill_paged(
            self.params, self.cfg, self.state, self._dev(toks),
            self._dev(lengths), self._dev(cached), self._dev(tables),
            self._dev(slots), resume=resume)
        do_sample = bool(temps.max() > 0.0)
        want_alt = any(r.sampling.logprobs for r in rows)
        if do_sample:
            tok, lp = sampling.sample_tokens(
                last, self._dev(np.maximum(lengths - 1, 0)),
                *(self._dev(a) for a in (temps, topks, topps, seeds)))
        else:
            tok, lp = sampling.greedy_tokens(last)
        out = self._host_out(tok, lp, last if want_alt else None, n)
        if obs.enabled:
            variant = (width, ls, do_sample, want_alt, resume)
            self._c_prefill.inc()
            extra = {}
            if chunk is not None:
                extra = {"chunk": chunk[0], "chunks_total": chunk[1]}
            obs.step("prefill", t0, self._now(), batch=n,
                     bucket=[width, ls],
                     first_dispatch=variant not in self._prefill_variants,
                     emitted=n,
                     computed_tokens=sum(r.suffix_len for r in rows),
                     padded_tokens=width * ls,
                     cached_tokens=sum(r.start for r in rows), **extra)
            self._prefill_variants.add(variant)
        return out

    @torch.inference_mode()
    def decode(self, tokens: np.ndarray, positions: np.ndarray,
               active: Optional[Sequence[int]] = None):
        """One batched decode step over all lanes. tokens / positions:
        (num_slots,) int32 host arrays; active: the lanes in the step (the
        scheduler's), or None for all. Lanes outside it keep their
        recurrent state. Returns ((num_slots,) int32 next tokens,
        (num_slots,) float32 chosen logprobs, alt)."""
        obs = self._obs
        t0 = self._now() if obs.enabled else 0.0
        do_sample = self.any_sampled
        if do_sample:
            self.sampled_dispatches += 1
        want_alt = self.any_alt
        mask = None
        if active is not None:
            lanes = np.zeros(self.num_slots, bool)
            lanes[list(active)] = True
            mask = self._dev(lanes)
        pos = self._dev(positions)
        logits, self.state = lm.decode_step_paged(
            self.params, self.cfg, self.state, self._dev(tokens), pos,
            self._tables_device(), active=mask)
        if do_sample:
            tok, lp = sampling.sample_tokens(logits, pos,
                                             *self._sampling_device())
        else:
            tok, lp = sampling.greedy_tokens(logits)
        out = self._host_out(tok, lp, logits if want_alt else None)
        if obs.enabled:
            variant = (do_sample, want_alt)
            self._c_decode.inc()
            obs.step("decode", t0, self._now(), batch=self.num_slots,
                     first_dispatch=variant not in self._decode_variants,
                     sampled=do_sample)
            self._decode_variants.add(variant)
        return out

    @torch.inference_mode()
    def verify(self, tokens: np.ndarray, positions: np.ndarray,
               counts: np.ndarray):
        """One batched multi-token verify dispatch. tokens: (num_slots,
        T) draft chains right-padded to a verify bucket; positions /
        counts: (num_slots,) int32 (counts 0 = lane sits out). Returns
        (emitted tokens (num_slots, T) int32, accept counts (num_slots,)
        int32, chosen logprobs (num_slots, T) float32, alt) — greedy
        lanes emit the model argmax at every position and accept the
        longest agreeing draft prefix; sampled lanes run Leviathan
        accept/reject with residual resampling (serving/sampling.py).
        Recurrent snapshots are held until the matching `commit`."""
        T = tokens.shape[1]
        obs = self._obs
        t0 = self._now() if obs.enabled else 0.0
        self.verify_shapes.add(T)
        self.verify_dispatches += 1
        self.verify_padded_tokens += tokens.shape[0] * T
        self.verify_chain_tokens += int(counts.sum())
        do_sample = self.any_sampled
        if do_sample:
            self.sampled_dispatches += 1
        want_alt = self.any_alt
        chain = self._dev(tokens)
        counts_dev = self._dev(counts)
        pos = self._dev(positions)
        logits, self.state, self._snaps = lm.decode_verify_paged(
            self.params, self.cfg, self.state, chain, pos, counts_dev,
            self._tables_device())
        if do_sample:
            emit, accept, lp = sampling.verify_tokens(
                logits, chain, counts_dev, pos, *self._sampling_device())
        else:
            emit, accept, lp = sampling.greedy_verify_tokens(
                logits, chain, counts_dev)
        alt = None
        if want_alt:
            ids, lps = sampling.top_alternatives(logits, self.max_logprobs)
            alt = (ids.cpu().numpy(), lps.cpu().numpy())
        out = (emit.cpu().numpy(), accept.cpu().numpy(), lp.cpu().numpy(),
               alt)
        if obs.enabled:
            variant = (T, do_sample, want_alt)
            self._c_verify.inc()
            obs.step("verify", t0, self._now(), batch=tokens.shape[0],
                     bucket=T,
                     first_dispatch=variant not in self._verify_variants,
                     chain_tokens=int(counts.sum()),
                     padded_tokens=tokens.shape[0] * T,
                     sampled=do_sample)
            self._verify_variants.add(variant)
        return out

    @torch.inference_mode()
    def commit(self, idx: np.ndarray) -> None:
        """Commit per-lane recurrent state at `idx` accepted chain tokens
        (0 = keep the pre-verify state) from the snapshots of the last
        `verify`, then drop them. Must follow every `verify`; a no-op for
        attention-only patterns, whose rollback is entirely positional."""
        if self._snaps is not None:
            self.state = lm.commit_decode_state(self.cfg, self.state,
                                                self._snaps, self._dev(idx))
        self._snaps = None

    @torch.inference_mode()
    def copy_block(self, src: int, dst: int) -> None:
        """Device-side copy-on-write: clone block `src`'s K/V into `dst`
        in every attention pool."""
        self.state = kv_cache.copy_block(self.cfg, self.state, src, dst)
        self.block_copies += 1
        self._c_copies.inc()

    # ------------------------------------------------------------------
    # host-tier payload movement (BlockAllocator demotion / revival)
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def fetch_block(self, block: int):
        """Device -> host: one block's payload from every attention pool
        (a kv_cache.gather_blocks tree of (1, ...) CPU tensors; quantized
        pools include the scale tables verbatim) — the allocator's
        host-tier demotion callback."""
        return kv_cache.gather_blocks(
            self.cfg, self.state,
            torch.tensor([block], dtype=torch.int64, device=self.device),
            device="cpu")

    @torch.inference_mode()
    def upload_blocks(self, ids: Sequence[int], payloads: Sequence) -> None:
        """Host -> device: scatter demoted payloads back into the pools at
        `ids` (the allocator's revival callback). The batch pads to a
        promote_buckets width, the pad lanes aimed at the reserved null
        block, as the JAX runner pads its one jitted scatter per width."""
        n = len(ids)
        w = pick_bucket(n, self.promote_buckets)
        self.promote_shapes.add(w)
        idarr = np.full(w, NULL_BLOCK, np.int64)
        idarr[:n] = ids
        layers = [[st for _, st in lm._layers(p, self.cfg)]
                  for p in payloads]

        def cat(leaves):
            out = torch.cat(leaves, dim=0)
            if w > n:
                out = torch.cat([out, out.new_zeros((w - n,)
                                                    + out.shape[1:])])
            return out

        merged = [{name: cat([pl[i][name] for pl in layers])
                   for name in layers[0][i]}
                  for i in range(len(layers[0]))]
        self.state = kv_cache.scatter_blocks(
            self.cfg, self.state, self._dev(idarr),
            lm._to_tree(self.cfg, merged))
