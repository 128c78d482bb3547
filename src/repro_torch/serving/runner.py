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

Pools are updated in place (the JAX runner donates them). Ported for
this slice: greedy decoding with kv_dtype "fp16". Sampled lanes, the
quantized pools and the host spill tier (`fetch_block` /
`upload_blocks`) raise NotImplementedError until their slice.
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
                                           width_buckets)
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


def _sampled_not_ported():
    raise NotImplementedError(
        "sampled lanes (temperature > 0) need the threefry fold_in draws "
        "of repro.serving.sampling, ported in a later slice")


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
        # per-slot sampling configs (host only: greedy is the only ported
        # mode, so nothing of them rides to the device)
        self._temps = np.zeros(num_slots, np.float32)
        self._wantk = np.zeros(num_slots, np.int32)
        self.max_logprobs = max(1, min(max_logprobs, cfg.vocab_size))

        self.prefill_shapes: set = set()     # distinct (width, Ls) dispatched
        self.verify_shapes: set = set()      # distinct chain buckets T
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
        if not sp.greedy:
            _sampled_not_ported()
        self._temps[slot] = sp.temperature
        self._wantk[slot] = min(sp.logprobs, self.max_logprobs)

    def clear_sampling(self, slot: int) -> None:
        self._temps[slot] = 0.0
        self._wantk[slot] = 0

    @property
    def any_sampled(self) -> bool:
        return bool(self._temps.max() > 0.0)

    @property
    def any_alt(self) -> bool:
        return bool(self._wantk.max() > 0)

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
        """Run one bucketed batched prefill and take each row's first
        token (greedy) from its true-last-position logits. Blocks until
        done (the caller's TTFT clock covers it). Returns ((len(rows),)
        int32 tokens, (len(rows),) float32 logprobs, alt) where alt is
        None unless a row asked for logprobs. `resume` / `chunk` as in
        the JAX runner (chunk is recorded on the trace)."""
        n = len(rows)
        obs = self._obs
        t0 = self._now() if obs.enabled else 0.0
        if any(not r.sampling.greedy for r in rows):
            _sampled_not_ported()
        ls = self.suffix_bucket(max(r.suffix_len for r in rows))
        width = pick_bucket(n, self.width_buckets)
        toks = np.zeros((width, ls), np.int32)
        lengths = np.zeros(width, np.int32)
        cached = np.zeros(width, np.int32)
        tables = np.full((width, self.max_blocks_per_seq), NULL_BLOCK,
                         np.int32)
        slots = np.full(width, self.num_slots, np.int32)   # pad rows drop
        for i, r in enumerate(rows):
            suf = r.tokens[r.start:]
            toks[i, :len(suf)] = suf
            lengths[i] = len(r.tokens)
            cached[i] = r.cached_len
            tables[i] = r.table_row
            slots[i] = r.slot
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
        want_alt = any(r.sampling.logprobs for r in rows)
        tok, lp = sampling.greedy_tokens(last)
        out = self._host_out(tok, lp, last if want_alt else None, n)
        if obs.enabled:
            variant = (width, ls, False, want_alt, resume)
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
    def decode(self, tokens: np.ndarray, positions: np.ndarray):
        """One batched greedy decode step over all lanes. tokens /
        positions: (num_slots,) int32 host arrays. Returns ((num_slots,)
        int32 next tokens, (num_slots,) float32 chosen logprobs, alt)."""
        obs = self._obs
        t0 = self._now() if obs.enabled else 0.0
        if self.any_sampled:
            _sampled_not_ported()
        want_alt = self.any_alt
        logits, self.state = lm.decode_step_paged(
            self.params, self.cfg, self.state, self._dev(tokens),
            self._dev(positions), self._tables_device())
        tok, lp = sampling.greedy_tokens(logits)
        out = self._host_out(tok, lp, logits if want_alt else None)
        if obs.enabled:
            variant = (False, want_alt)
            self._c_decode.inc()
            obs.step("decode", t0, self._now(), batch=self.num_slots,
                     first_dispatch=variant not in self._decode_variants,
                     sampled=False)
            self._decode_variants.add(variant)
        return out

    @torch.inference_mode()
    def verify(self, tokens: np.ndarray, positions: np.ndarray,
               counts: np.ndarray):
        """One batched multi-token greedy verify dispatch. tokens:
        (num_slots, T) draft chains right-padded to a verify bucket;
        positions / counts: (num_slots,) int32 (counts 0 = lane sits
        out). Returns (emitted tokens (num_slots, T) int32, accept counts
        (num_slots,) int32, chosen logprobs (num_slots, T) float32, alt)
        — greedy lanes emit the model argmax at every position and accept
        the longest agreeing draft prefix."""
        T = tokens.shape[1]
        obs = self._obs
        t0 = self._now() if obs.enabled else 0.0
        if self.any_sampled:
            _sampled_not_ported()
        self.verify_shapes.add(T)
        self.verify_dispatches += 1
        self.verify_padded_tokens += tokens.shape[0] * T
        self.verify_chain_tokens += int(counts.sum())
        want_alt = self.any_alt
        chain = self._dev(tokens)
        counts_dev = self._dev(counts)
        logits, self.state, _ = lm.decode_verify_paged(
            self.params, self.cfg, self.state, chain, self._dev(positions),
            counts_dev, self._tables_device())
        emit, accept, lp = sampling.greedy_verify_tokens(logits, chain,
                                                         counts_dev)
        alt = None
        if want_alt:
            ids, lps = sampling.top_alternatives(logits, self.max_logprobs)
            alt = (ids.cpu().numpy(), lps.cpu().numpy())
        out = (emit.cpu().numpy(), accept.cpu().numpy(), lp.cpu().numpy(),
               alt)
        if obs.enabled:
            variant = (T, False, want_alt)
            self._c_verify.inc()
            obs.step("verify", t0, self._now(), batch=tokens.shape[0],
                     bucket=T,
                     first_dispatch=variant not in self._verify_variants,
                     chain_tokens=int(counts.sum()),
                     padded_tokens=tokens.shape[0] * T,
                     sampled=False)
            self._verify_variants.add(variant)
        return out

    def commit(self, idx: np.ndarray) -> None:
        """Commit per-lane recurrent state at `idx` accepted chain tokens
        after a `verify` — a no-op for the attention-only architectures
        of this slice, whose rollback is entirely positional."""

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

    def fetch_block(self, block: int):
        raise NotImplementedError(
            "the host KV spill tier is not ported yet (a later slice)")

    def upload_blocks(self, ids: Sequence[int], payloads: Sequence) -> None:
        raise NotImplementedError(
            "the host KV spill tier is not ported yet (a later slice)")
