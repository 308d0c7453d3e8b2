"""Continuous-batching inference engine (FastGen equivalent).

Port of ``deepspeed_tpu/inference/v2/engine_v2.py``: ``put(batch_uids,
batch_tokens)`` admits sequences and runs one step; ``query`` /
``can_schedule`` gate admission on free KV blocks; per step the SplitFuse
plan becomes one bucketed ``prefill_chunk_g`` call per admitted chunk and
one padded ``decode_step_g`` call for all running decodes. The plans, the
buckets and the block bookkeeping are the reference's, so greedy decoding
gives the reference's tokens.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU it raises. Per step, the host uploads the
chunk's tokens and table (or the decode batch's tokens, positions and valid
flags, and its tables when they changed) and reads back only the sampled
ids.

The host KV tier (``kv_offload.py``): ``demote_kv`` spills a sequence's
pages to host RAM (full width, or int8/fp8 per page) and pauses it,
``promote_kv`` brings them back into free blocks; ``kv_ledger``,
``kv_resident_bytes``, ``resident_tokens``, ``demoted_uids``,
``demoted_blocks`` and ``host_kv_bytes`` gauge both tiers.

The three KV handoffs: ``adopt_kv_handoff`` continues a sequence a
prefill-role engine demoted (``serving/disagg.py``); ``export_prefix_handoff``
and ``import_prefix_handoff`` carry a retiring fleet replica's prefix cache
to its successor through an ``.npz`` file (``serving/fleet.py``).
"""

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.inference.v2.generic_decode import (decode_step_g,
                                                             prefill_chunk_g,
                                                             verify_chunk_g)
from deepspeed_tpu_torch.inference.v2.kv_cache import (BlockedKVCache,
                                                       KVCacheConfig)
from deepspeed_tpu_torch.inference.v2.kv_offload import (HostKVEntry,
                                                         HostKVStore,
                                                         dequantize_pages,
                                                         from_handoff_array,
                                                         quantize_pages,
                                                         to_handoff_array)
from deepspeed_tpu_torch.inference.v2.modules import policy_for
from deepspeed_tpu_torch.inference.v2.prefix_cache import PrefixCache
from deepspeed_tpu_torch.inference.v2.ragged_manager import (SequenceDescriptor,
                                                             StateManager)
from deepspeed_tpu_torch.inference.v2.sampling import (SamplingConfig,
                                                       sample_tokens)
from deepspeed_tpu_torch.inference.v2.scheduler import (SchedulerConfig,
                                                        plan_step, snap_bucket)
from deepspeed_tpu_torch.models.convert import params_device
from deepspeed_tpu_torch.runtime.sched import TickLedger
from deepspeed_tpu_torch.telemetry.tracer import get_tracer
from deepspeed_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class V2EngineConfig:
    kv_block_size: int = 64
    kv_num_blocks: int = 512
    max_tracked_sequences: int = 256
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    decode_batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
    ctx_block_buckets: Tuple[int, ...] = (4, 8, 16, 32, 64)   # blocks per table
    eos_token_id: Optional[int] = None
    greedy: bool = True            # back-compat; sampling is the full control
    sampling: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)
    # attention implementation: auto (CUDA kernel on the card, plain version
    # on the CPU), kernel, gather — see llama_decode._paged_attn
    attn_impl: str = "auto"
    # KV page dtype: "model" stores pages in the model dtype; "fp8" stores
    # float8_e4m3 pages with per-(head, page) fp32 scales (half the KV
    # memory of bf16)
    kv_cache_dtype: str = "model"
    # draft-free speculative decoding (prompt-lookup): verify the k tokens
    # that followed the last occurrence of the trailing n-gram in ONE chunk
    # forward, accept the longest argmax-matching prefix + one bonus token.
    # 0 = off; greedy-only
    speculative_k: int = 0
    speculative_ngram: int = 3
    # block-granular radix prefix cache (prefix_cache.py); default off
    prefix_cache_enabled: bool = False
    # soft cap on UNPINNED cached blocks (0 = unlimited up to pool size)
    prefix_cache_max_blocks: int = 0


class InferenceEngineV2:
    """Serves the Llama family through the policy registry."""

    def _page_dtype(self, spec):
        kinds = {"model": spec.dtype, "fp8": torch.float8_e4m3fn}
        kvd = self.config.kv_cache_dtype
        if kvd not in kinds:
            raise ValueError(f"unknown kv_cache_dtype {kvd!r}; one of "
                             f"{sorted(kinds)}")
        return kinds[kvd]

    def __init__(self, params, model_config,
                 config: Optional[V2EngineConfig] = None, device=None):
        self.device = resolve_device(device)
        if params_device(params).type != self.device.type:
            raise ValueError(f"params live on {params_device(params)}, the "
                             f"engine runs on {self.device}")
        self.params = params
        self.model_config = model_config
        self.config = config or V2EngineConfig()
        if self.config.speculative_k > 0 and not self.config.greedy:
            # reject BEFORE any sequence state exists: failing inside
            # _speculative_step would leave a half-processed sequence whose
            # prefill already consumed KV blocks
            raise ValueError(
                "speculative_k > 0 requires greedy=True: proposal "
                "acceptance compares argmax chains, which sampling breaks")
        self.policy = policy_for(model_config)
        spec = self.policy.cache_spec(model_config)
        self.kv = BlockedKVCache(KVCacheConfig(
            num_layers=spec.num_layers,
            num_kv_heads=spec.num_kv_heads,
            head_dim=spec.head_dim,
            block_size=self.config.kv_block_size,
            num_blocks=self.config.kv_num_blocks,
            dtype=self._page_dtype(spec)), self.device)
        self.state = StateManager(
            max_tracked_sequences=self.config.max_tracked_sequences,
            max_context_length=spec.max_seq_len)
        if not self.config.greedy and \
                self.config.sampling.temperature <= 0.0:
            self.config = dataclasses.replace(
                self.config,
                sampling=dataclasses.replace(self.config.sampling,
                                             temperature=1.0))
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.config.sampling.seed)
        # persistent device-side decode tables: the [B, MB] table upload is
        # skipped while the allocation signature (bucket shape + every
        # sequence's block-id list) is unchanged
        self._table_sig = None
        self._dev_tables = None
        # radix prefix cache over KV pages (prefix_cache.py); None = off
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.config.kv_block_size,
                        self.config.prefix_cache_max_blocks)
            if self.config.prefix_cache_enabled else None)
        # prefill-work conservation counters (prefix_stats): at drain,
        # saved + computed == total exactly
        self._prefill_total = 0
        self._prefill_saved = 0
        self._prefill_computed = 0
        # last step's host-timed prefill/decode split
        self.last_step_timing = {"prefill_s": 0.0, "decode_s": 0.0}
        # deterministic per-tick scheduler counters (runtime/sched.py)
        self.sched_ledger = TickLedger()
        self.last_step_counters = {"prefill_tokens": 0, "chunks": 0,
                                   "decode_tokens": 0}
        # speculative-decoding counters (speculative_stats)
        self._spec_steps = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        # host KV tier: demoted sequences' pages (kv_offload.py)
        self.host_kv = HostKVStore()

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without waiting for the device
        (pinned staging + a non-blocking copy on the card)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def enable_prefix_cache(self, max_cached_blocks: int = 0) -> None:
        """Turn the radix prefix cache on (idempotent)."""
        if self.prefix_cache is None:
            self.prefix_cache = PrefixCache(self.config.kv_block_size,
                                            max_cached_blocks)

    def configure_chunked_prefill(self, prefill_chunk_tokens: int) -> None:
        """Set the decode-first prefill cap. The cap must cover at least one
        KV block: capped mid-prompt boundaries snap DOWN to block
        granularity, so a smaller cap could never make progress."""
        cap = int(prefill_chunk_tokens)
        if cap > 0 and cap < self.kv.cfg.block_size:
            raise ValueError(
                f"prefill_chunk_tokens={cap} is smaller than the KV block "
                f"size ({self.kv.cfg.block_size}): block-aligned chunking "
                f"could never make progress")
        self.config = dataclasses.replace(
            self.config, scheduler=dataclasses.replace(
                self.config.scheduler, prefill_chunk_tokens=cap))

    def sched_mark(self) -> None:
        """Start the measured counter window."""
        self.sched_ledger.reset_window()

    def sched_stats(self, gap_unit_tokens: int = 0) -> Dict[str, object]:
        """The scheduler proof set (see TickLedger.snapshot)."""
        return self.sched_ledger.snapshot(
            cap=self.config.scheduler.prefill_chunk_tokens,
            gap_unit_tokens=gap_unit_tokens)

    # ------------------------------------------------------------------
    # admission control
    # ------------------------------------------------------------------
    def query(self, uid: int, max_request_length: int) -> Tuple[int, int]:
        """Returns (max_new_blocks_needed, free_blocks)."""
        seq = self.state.get(uid)
        tracked = seq.total_tokens if seq else 0
        needed = self.kv.blocks_needed(tracked + max_request_length) - \
            (len(seq.blocks) if seq else 0)
        return needed, self.kv.free_blocks

    def can_schedule(self, uids: Sequence[int],
                     lengths: Sequence[int]) -> bool:
        total = 0
        for uid, n in zip(uids, lengths):
            needed, _ = self.query(uid, n)
            total += needed
        # unpinned cached prefix blocks count as schedulable capacity:
        # they are evicted on demand the moment a reservation needs them
        return total <= self.kv.free_blocks + self._evictable_blocks() and \
            len(self.state) + len([u for u in uids if u not in self.state]) <= \
            self.state.max_tracked_sequences

    # ------------------------------------------------------------------
    # block bookkeeping
    # ------------------------------------------------------------------
    def _evictable_blocks(self) -> int:
        return (self.prefix_cache.evictable_blocks()
                if self.prefix_cache is not None else 0)

    def _reserve(self, num_blocks: int) -> List[int]:
        """Reserve device blocks, reclaiming unpinned prefix-cache blocks
        on demand when the free list alone can't cover the request."""
        if self.prefix_cache is not None and \
                num_blocks > self.kv.free_blocks:
            self.evict_prefix_blocks(num_blocks - self.kv.free_blocks)
        return self.kv.reserve(num_blocks)

    def evict_prefix_blocks(self, want: int) -> int:
        """Evict up to ``want`` unpinned cached blocks (LRU leaf-first) and
        release them to the allocator. Returns blocks actually freed."""
        if self.prefix_cache is None or want <= 0:
            return 0
        blocks = self.prefix_cache.evict_blocks(
            self.prefix_cache.plan_evictions(want))
        if blocks:
            self.kv.release(blocks)
        return len(blocks)

    def _ensure_blocks(self, seq: SequenceDescriptor, up_to_tokens: int):
        need = self.kv.blocks_needed(up_to_tokens) - len(seq.blocks)
        if need > 0:
            seq.blocks.extend(self._reserve(need))

    def _block_table(self, seq: SequenceDescriptor, bucket_blocks: int) -> np.ndarray:
        trash = self.kv.cfg.num_blocks - 1
        table = np.full((bucket_blocks,), trash, dtype=np.int32)
        n = min(len(seq.blocks), bucket_blocks)
        table[:n] = seq.blocks[:n]
        return table

    def _ctx_bucket_blocks(self, tokens: int) -> int:
        blocks = self.kv.blocks_needed(max(tokens, 1))
        return snap_bucket(blocks, self.config.ctx_block_buckets)

    def _cache(self):
        return self.kv.data if self.kv.scales is None else \
            (self.kv.data, self.kv.scales)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def put(self, batch_uids: Sequence[int], batch_tokens: Sequence[Sequence[int]],
            do_checks: bool = True) -> Dict[int, int]:
        """Admit new/continued sequences and run ONE engine step. Returns
        {uid: next_token} for every sequence that produced a token."""
        if do_checks and not self.can_schedule(
                batch_uids, [len(t) for t in batch_tokens]):
            raise RuntimeError("cannot schedule batch: out of KV blocks or slots")
        for uid, toks in zip(batch_uids, batch_tokens):
            if uid in self.state:
                seq = self.state.get(uid)
                seq.prompt_tokens = np.concatenate(
                    [seq.prompt_tokens, np.asarray(toks, np.int32)])
                seq.done = False
                self._prefill_total += len(toks)
            else:
                self._prefix_admit(self.state.create(uid, toks))
        return self.step()

    def _prefix_admit(self, seq: SequenceDescriptor) -> int:
        """Prefix-cache admission for a freshly created sequence: pin the
        longest cached full-block prefix of its prompt, seed its block
        table with the shared pages, and mark that prefix as already seen.
        Returns the reused token count."""
        self._prefill_total += len(seq.prompt_tokens)
        if self.prefix_cache is None:
            return 0
        blocks, matched = self.prefix_cache.admit_match(
            seq.uid, seq.prompt_tokens)
        if matched:
            seq.blocks = list(blocks)
            seq.seen_tokens = matched
            self._prefill_saved += matched
        return matched

    def step(self) -> Dict[int, int]:
        cap = self.config.scheduler.prefill_chunk_tokens
        plan = plan_step(self.state.decoding(), self.state.prefilling(),
                         self.config.scheduler,
                         block_tokens=self.kv.cfg.block_size)
        out: Dict[int, int] = {}
        cache = self._cache()
        tracer = get_tracer()
        t_prefill = t_decode = 0.0
        t0 = time.monotonic()

        # --- prefill chunks (SplitFuse) ---
        for chunk in plan.prefill_chunks:
            seq = chunk.seq
            end = chunk.start + chunk.length
            self._ensure_blocks(seq, end)
            tokens = np.zeros((chunk.bucket,), np.int32)
            tokens[:chunk.length] = seq.prompt_tokens[chunk.start:end]
            table = self._block_table(seq, self._ctx_bucket_blocks(end))
            t_chunk = time.monotonic()
            logits, cache = prefill_chunk_g(
                self.params, cache, self._upload(tokens), chunk.start,
                self._upload(table), chunk.length,
                policy=self.policy, cfg=self.model_config,
                block_size=self.kv.cfg.block_size,
                attn_impl=self.config.attn_impl)
            if cap > 0:
                tracer.complete("serve/prefill_chunk",
                                time.monotonic() - t_chunk, cat="serve",
                                uid=seq.uid, tokens=chunk.length,
                                bucket=chunk.bucket)
            seq.seen_tokens = end
            self._prefill_computed += chunk.length
            if self.prefix_cache is not None:
                # register the freshly materialized FULL prompt blocks so
                # concurrent arrivals with the same prefix reuse them
                self.prefix_cache.insert_from_seq(
                    seq.uid, seq.prompt_tokens, seq.blocks,
                    min(seq.seen_tokens, len(seq.prompt_tokens)))
            if not seq.in_prefill:
                tok = int(self._sample_batch(logits[None])[0])
                seq.generated.append(tok)
                out[seq.uid] = tok
        if plan.prefill_chunks:
            t_prefill = time.monotonic() - t0
            tracer.complete("serve/step_prefill", t_prefill, cat="serve",
                            chunks=len(plan.prefill_chunks))

        # --- decode batch ---
        t0 = time.monotonic()
        if plan.decode_seqs:
            seqs = plan.decode_seqs
            b = snap_bucket(len(seqs), self.config.decode_batch_buckets)
            mb = self._ctx_bucket_blocks(max(s.total_tokens for s in seqs))
            # rows: tokens, positions, valid — one upload
            step_in = np.zeros((3, b), np.int32)
            for j, seq in enumerate(seqs):
                self._ensure_blocks(seq, seq.total_tokens)
                step_in[0, j] = seq.generated[-1] if seq.generated else \
                    seq.prompt_tokens[-1]
                step_in[1, j] = seq.total_tokens - 1
                step_in[2, j] = 1
            # signature covers the actual block ids: uid reuse after flush()
            # can hand a same-shaped batch different pages
            sig = (b, mb, tuple(tuple(s.blocks) for s in seqs))
            if sig != self._table_sig:
                tables = np.full((b, mb), self.kv.cfg.num_blocks - 1, np.int32)
                for j, seq in enumerate(seqs):
                    tables[j] = self._block_table(seq, mb)
                self._dev_tables = self._upload(tables)
                self._table_sig = sig
            dev_in = self._upload(step_in)
            logits, cache = decode_step_g(
                self.params, cache, dev_in[0], dev_in[1], self._dev_tables,
                dev_in[2].bool(), policy=self.policy, cfg=self.model_config,
                block_size=self.kv.cfg.block_size,
                attn_impl=self.config.attn_impl)
            # sample on the device; only [B] token ids cross to the host
            toks = self._sample_batch(logits)
            for j, seq in enumerate(seqs):
                tok = int(toks[j])
                seq.seen_tokens = seq.total_tokens
                seq.generated.append(tok)
                out[seq.uid] = tok
                if self.config.eos_token_id is not None and \
                        tok == self.config.eos_token_id:
                    seq.done = True
            t_decode = time.monotonic() - t0
            tracer.complete("serve/step_decode", t_decode, cat="serve",
                            batch=len(plan.decode_seqs))

        self.last_step_timing = {"prefill_s": t_prefill,
                                 "decode_s": t_decode}
        prefill_tokens = sum(c.length for c in plan.prefill_chunks)
        decode_tokens = len(plan.decode_seqs)
        self.last_step_counters = {"prefill_tokens": prefill_tokens,
                                   "chunks": len(plan.prefill_chunks),
                                   "decode_tokens": decode_tokens}
        if not plan.empty:
            self.sched_ledger.observe_tick(prefill_tokens,
                                           len(plan.prefill_chunks),
                                           decode_tokens, cap=cap)
        return out

    def _sample_batch(self, logits: torch.Tensor) -> np.ndarray:
        """[B, V] device logits -> [B] host token ids (one small D2H)."""
        return sample_tokens(logits, self._gen, self.config.sampling).cpu().numpy()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def flush(self, uid: int) -> List[int]:
        """Release a sequence's KV blocks; returns its generated tokens.
        With the prefix cache on, full blocks covering the materialized
        prompt+generated history are absorbed into the trie instead of
        freed (refcount 0, evictable), and blocks the cache owns are kept
        out of the allocator release."""
        seq = self.state.pop(uid)
        if seq.in_prefill:
            # cancelled mid-prefill: the never-computed remainder leaves
            # the conservation identity (saved + computed == total) exact
            self._prefill_total -= max(
                len(seq.prompt_tokens) - seq.seen_tokens, 0)
        if self.prefix_cache is not None:
            history = np.concatenate(
                [seq.prompt_tokens,
                 np.asarray(seq.generated, np.int32)]) if seq.generated \
                else seq.prompt_tokens
            self.prefix_cache.insert_from_seq(
                uid, history, seq.blocks, seq.seen_tokens, pin=False)
            self.prefix_cache.release_seq(uid)
            cache = self.prefix_cache
            self.kv.release([b for b in seq.blocks if not cache.owns(b)])
        else:
            self.kv.release(seq.blocks)
        self.host_kv.pop(uid)     # no-op unless the sequence was demoted
        return seq.generated

    # ------------------------------------------------------------------
    # host KV offload tier (serving demotion/promotion; kv_offload.py)
    # ------------------------------------------------------------------
    def demote_kv(self, uid: int, quantize: str = "none") -> int:
        """Spill a sequence's KV pages to host RAM and release its device
        blocks; the sequence pauses (invisible to the step planner) until
        ``promote_kv``. Returns the host bytes now held for it (0 when the
        uid is unknown, done or already demoted). ``quantize`` is the
        host-tier page codec ("none" | "int8" | "fp8"); device-fp8 pages
        are never re-quantized. Pages the prefix cache owns stay on the
        device for their other readers and travel in the entry too."""
        seq = self.state.get(uid)
        if seq is None or seq.paused or seq.done:
            return 0
        data, scales = self.kv.gather_blocks(seq.blocks) if seq.blocks \
            else (None, None)
        raw = (data.numel() * data.element_size() if data is not None else 0) \
            + (scales.numel() * scales.element_size()
               if scales is not None else 0)
        codec, qscales = "none", None
        if data is not None and quantize != "none" and \
                self.kv.cfg.dtype != torch.float8_e4m3fn:
            data, qscales = quantize_pages(data, quantize)
            codec = quantize
        entry = HostKVEntry(blocks=len(seq.blocks), data=data, scales=scales,
                            seen_tokens=seq.seen_tokens, codec=codec,
                            qscales=qscales, raw_nbytes=raw)
        self.host_kv.put(uid, entry)
        if self.prefix_cache is not None:
            self.prefix_cache.release_seq(uid)
            cache = self.prefix_cache
            self.kv.release([b for b in seq.blocks if not cache.owns(b)])
        else:
            self.kv.release(seq.blocks)
        seq.blocks = []
        seq.paused = True
        self._table_sig = None    # decode tables must rebuild
        return entry.nbytes

    def promote_kv(self, uid: int) -> Optional[int]:
        """Bring a demoted sequence back: reserve (possibly other) device
        blocks, scatter its pages in, resume scheduling. Returns the bytes
        restored, or None when the uid is unknown, done, or the device has
        too few free blocks right now."""
        seq = self.state.get(uid)
        entry = self.host_kv.get(uid)
        if seq is None or entry is None or seq.done:
            return None
        if entry.blocks > self.kv.free_blocks + self._evictable_blocks():
            return None
        blocks = self._reserve(entry.blocks)
        if entry.blocks:
            data = dequantize_pages(entry.data, entry.qscales, entry.codec,
                                    torch.float32 if entry.codec != "none"
                                    else entry.data.dtype)
            self.kv.scatter_blocks(blocks, data, entry.scales)
        seq.blocks = list(blocks)
        seq.paused = False
        self.host_kv.pop(uid, promoted=True)
        self._table_sig = None
        return entry.nbytes

    def adopt_kv_handoff(self, uid: int, prompt_tokens: Sequence[int],
                         generated: Sequence[int],
                         entry: HostKVEntry) -> bool:
        """In-process disaggregation adoption (``serving/disagg.py``):
        continue a sequence whose KV a prefill-role engine demoted into a
        ``HostKVEntry``. Create it here with its history, reserve device
        blocks, scatter the dequantized pages, and let the planner pick it
        up as a running decode. Prefix admission is bypassed: the prefill
        work was done (and counted) on the donor engine. Returns False with
        nothing mutated when this engine cannot cover the entry right now
        (capacity, slots, a uid collision); the caller retries next tick."""
        if uid in self.state or \
                len(self.state) >= self.state.max_tracked_sequences or \
                entry.blocks > self.kv.free_blocks + self._evictable_blocks():
            return False
        seq = self.state.create(uid, prompt_tokens)
        seq.generated = list(generated)
        blocks = self._reserve(entry.blocks)
        if entry.blocks:
            data = dequantize_pages(entry.data, entry.qscales, entry.codec,
                                    torch.float32 if entry.codec != "none"
                                    else entry.data.dtype)
            self.kv.scatter_blocks(blocks, data, entry.scales)
        seq.blocks = list(blocks)
        seq.seen_tokens = int(entry.seen_tokens)
        self._table_sig = None
        return True

    # ------------------------------------------------------------------
    # fleet prefix handoff (drain-time export / adopt-time import)
    # ------------------------------------------------------------------
    def export_prefix_handoff(self, path: str,
                              quantize: str = "none") -> Dict[str, int]:
        """Serialize every cached prefix chain to ``path`` (npz): for each
        root-to-leaf trie chain, the token key and its KV pages gathered
        from the device through the host-tier codec (``quantize``: "none" |
        "int8" | "fp8", as ``demote_kv``; device-fp8 pages are never
        re-quantized). A retiring fleet replica's warm cache for its
        successor. Pages numpy cannot hold (bf16, fp8) are written as raw
        bits with a dtype tag (``kv_offload.to_handoff_array``). A
        deliberate device-to-host gather, made at drain time only."""
        cache = self.prefix_cache
        out = {"chains": 0, "blocks": 0, "stored_bytes": 0, "raw_bytes": 0}
        payload: Dict[str, np.ndarray] = {}
        for tokens, blocks in (cache.chains() if cache is not None else ()):
            data, scales = self.kv.gather_blocks(list(blocks))
            raw = data.numel() * data.element_size() + (
                scales.numel() * scales.element_size()
                if scales is not None else 0)
            codec, qscales = "none", None
            if quantize != "none" and self.kv.cfg.dtype != torch.float8_e4m3fn:
                data, qscales = quantize_pages(data, quantize)
                codec = quantize
            entry = HostKVEntry(blocks=len(blocks), data=data, scales=scales,
                                seen_tokens=len(tokens), codec=codec,
                                qscales=qscales, raw_nbytes=raw)
            i = out["chains"]
            payload[f"tokens_{i}"] = np.asarray(tokens, np.int32)
            payload[f"data_{i}"], tag = to_handoff_array(entry.data)
            if tag is not None:
                payload[f"dtype_{i}"] = np.array(tag)
            payload[f"codec_{i}"] = np.array(entry.codec)
            if entry.scales is not None:
                payload[f"scales_{i}"] = entry.scales.numpy()
            if entry.qscales is not None:
                payload[f"qscales_{i}"] = entry.qscales.numpy()
            out["chains"] += 1
            out["blocks"] += entry.blocks
            out["stored_bytes"] += entry.nbytes
            out["raw_bytes"] += raw
        payload["block_size"] = np.asarray(self.config.kv_block_size,
                                           np.int32)
        payload["num_chains"] = np.asarray(out["chains"], np.int32)
        with open(path, "wb") as f:
            np.savez(f, **payload)
        return out

    def import_prefix_handoff(self, path: str) -> Dict[str, int]:
        """Adopt a predecessor's exported prefix chains: reserve device
        blocks, scatter the dequantized pages, and register each chain in
        the trie as evictable nodes (refcount 0: a warm start, not a pin).
        Chains that do not fit the free pool, mismatch the block geometry,
        or collide with incumbents are skipped or trimmed and counted.
        Deliberate host-to-device copies: wire it through
        ``InferenceServer.adopt_prefix_handoff`` so the serve-loop thread
        (the engine's owner) runs it between ticks."""
        out = {"chains": 0, "blocks": 0, "skipped": 0, "bytes": 0}
        cache = self.prefix_cache
        with np.load(path, allow_pickle=False) as z:
            n = int(z["num_chains"]) if "num_chains" in z else 0
            bs = int(z["block_size"]) if "block_size" in z else -1
            for i in range(n):
                tokens = [int(t) for t in z[f"tokens_{i}"]]
                raw = z[f"data_{i}"]
                tag = str(z[f"dtype_{i}"]) if f"dtype_{i}" in z.files \
                    else None
                codec = str(z[f"codec_{i}"])
                scales = (torch.from_numpy(z[f"scales_{i}"])
                          if f"scales_{i}" in z.files else None)
                qscales = (torch.from_numpy(z[f"qscales_{i}"])
                           if f"qscales_{i}" in z.files else None)
                nb = int(raw.shape[3])
                if (cache is None or bs != self.config.kv_block_size
                        or nb > self.kv.free_blocks):
                    out["skipped"] += 1
                    continue
                blocks = self.kv.reserve(nb)
                try:
                    stored = from_handoff_array(raw, tag)
                    data = dequantize_pages(stored, qscales, codec,
                                            torch.float32 if codec != "none"
                                            else stored.dtype)
                    self.kv.scatter_blocks(blocks, data, scales)
                except Exception:
                    # geometry mismatch (another model or layout): give the
                    # reservation back and skip, so that adoption never
                    # poisons a healthy successor
                    self.kv.release(blocks)
                    out["skipped"] += 1
                    continue
                added = cache.insert_from_seq(0, tokens, blocks,
                                              seen_tokens=len(tokens),
                                              pin=False)
                # chain prefixes the trie already held keep the incumbent
                # pages (first writer wins); unclaimed reservations go
                # straight back to the allocator
                self.kv.release([b for b in blocks if not cache.owns(b)])
                out["chains"] += 1
                out["blocks"] += added
                out["bytes"] += int(raw.nbytes)
        return out

    def demoted_uids(self) -> List[int]:
        """Demotion-ordered uids currently in the host tier."""
        return self.host_kv.uids()

    def demoted_blocks(self, uid: int) -> int:
        """Device blocks a demoted sequence will need back at promotion."""
        entry = self.host_kv.get(uid)
        return entry.blocks if entry is not None else 0

    def host_kv_bytes(self) -> int:
        return self.host_kv.total_bytes

    def kv_ledger(self) -> Dict[str, int]:
        """Both tiers' occupancy in one dict. ``device_blocks_reserved``
        excludes prefix-cache-held blocks (``prefix_cached_blocks``)."""
        cached = (self.prefix_cache.cached_blocks()
                  if self.prefix_cache is not None else 0)
        return {
            "device_blocks_reserved": self.kv_reserved_blocks() - cached,
            "device_block_bytes": self.kv_block_bytes(),
            "prefix_cached_blocks": cached,
            "host_entries": len(self.host_kv),
            "host_bytes": self.host_kv.total_bytes,
            "host_raw_bytes": self.host_kv.raw_bytes,
            "demotions": self.host_kv.demotions,
            "promotions": self.host_kv.promotions,
            "demoted_bytes": self.host_kv.demoted_bytes,
            "promoted_bytes": self.host_kv.promoted_bytes,
            "demoted_raw_bytes": self.host_kv.demoted_raw_bytes,
            "host_compression_ratio": self.host_kv.compression_ratio(),
        }

    def resident_tokens(self) -> int:
        """Tokens whose KV is resident in either tier right now."""
        total = sum(s.seen_tokens for s in self.state.all() if not s.paused)
        for u in self.host_kv.uids():
            entry = self.host_kv.get(u)
            if entry is not None:
                total += entry.seen_tokens
        return total

    def kv_resident_bytes(self) -> int:
        """Bytes holding resident KV across both tiers (device blocks at
        block-byte width + host entries at stored width)."""
        return (self.kv_reserved_blocks() * self.kv_block_bytes()
                + self.host_kv.total_bytes)

    def prefix_stats(self) -> Dict[str, float]:
        """Prefix-cache counters + the prefill-work conservation triple:
        ``prefill_tokens_saved + prefill_tokens_computed ==
        prefill_tokens_total`` once every admitted sequence has finished
        prefill or been flushed."""
        out: Dict[str, float] = {
            "prefill_tokens_total": self._prefill_total,
            "prefill_tokens_saved": self._prefill_saved,
            "prefill_tokens_computed": self._prefill_computed,
        }
        if self.prefix_cache is not None:
            for k, v in self.prefix_cache.snapshot().items():
                out[f"prefix_{k}"] = v
            looked = max(self.prefix_cache.stats.lookup_tokens, 1)
            out["prefix_hit_ratio"] = \
                self.prefix_cache.stats.hit_tokens / looked
        return out

    # ------------------------------------------------------------------
    # serving hooks: admit without stepping, step in the caller's cadence,
    # reap finished sequences between steps
    # ------------------------------------------------------------------
    def admit(self, uid: int, prompt_tokens: Sequence[int]) -> SequenceDescriptor:
        """Admission-only: create sequence state WITHOUT running a step, so
        a burst of arrivals lands in one SplitFuse plan."""
        if not self.can_schedule([uid], [len(prompt_tokens)]):
            raise RuntimeError(
                "cannot admit: out of KV blocks or sequence slots")
        seq = self.state.create(uid, prompt_tokens)
        self._prefix_admit(seq)
        return seq

    def finish(self, uid: int) -> None:
        """Mark a sequence done (length limit / cancel) so the scheduler
        stops planning it; KV blocks are released at reap time."""
        seq = self.state.get(uid)
        if seq is not None:
            seq.done = True

    def finished_uids(self) -> List[int]:
        return [s.uid for s in self.state.all() if s.done]

    def reap_finished(self) -> Dict[int, List[int]]:
        """Flush every done sequence; returns {uid: generated_tokens}."""
        return {uid: self.flush(uid) for uid in self.finished_uids()}

    def has_work(self) -> bool:
        return any(not s.done and not s.paused for s in self.state.all())

    # ------------------------------------------------------------------
    # KV gauges (host arithmetic, never a transfer)
    # ------------------------------------------------------------------
    def kv_usable_blocks(self) -> int:
        """Blocks available to sequences (the last block is the trash page)."""
        return self.kv.cfg.num_blocks - 1

    def kv_occupancy(self) -> float:
        """Fraction of usable KV cache blocks currently reserved (0..1)."""
        usable = self.kv_usable_blocks()
        return (usable - self.kv.free_blocks) / max(usable, 1)

    def kv_reserved_blocks(self) -> int:
        return self.kv_usable_blocks() - self.kv.free_blocks

    def kv_held_blocks(self, uid: int) -> int:
        seq = self.state.get(uid)
        return len(seq.blocks) if seq is not None else 0

    def kv_block_bytes(self) -> int:
        """Device bytes per KV block across all layers/heads."""
        nbytes = self.kv.data.numel() * self.kv.data.element_size()
        if self.kv.scales is not None:
            nbytes += self.kv.scales.numel() * self.kv.scales.element_size()
        return nbytes // max(self.kv.cfg.num_blocks, 1)

    def generate(self, prompt_tokens: Sequence[int], max_new_tokens: int = 32,
                 uid: int = 0) -> List[int]:
        """Serial generation over the continuous-batching step; with
        ``speculative_k > 0`` each step verifies a prompt-lookup proposal
        in one chunk forward (1..k+1 tokens/step, exact greedy)."""
        self.put([uid], [list(prompt_tokens)])
        seq = self.state.get(uid)
        while len(seq.generated) < max_new_tokens and not seq.done:
            if self.config.speculative_k > 0 and not seq.in_prefill:
                self._speculative_step(seq)
            else:
                self.step()
        # a fully-accepted verify step can overshoot the budget by up to k
        return self.flush(uid)[:max_new_tokens]

    # ------------------------------------------------------------------
    # speculative decoding (draft-free prompt-lookup)
    # ------------------------------------------------------------------
    def _propose(self, seq: SequenceDescriptor) -> List[int]:
        """The k tokens that followed the previous occurrence of the
        context's trailing n-gram (most recent occurrence wins); empty when
        the tail never repeats."""
        k, n = self.config.speculative_k, self.config.speculative_ngram
        ctx = np.concatenate([seq.prompt_tokens,
                              np.asarray(seq.generated, np.int32)])
        if len(ctx) < n + 1:
            return []
        tail = ctx[-n:]
        windows = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
        hits = np.flatnonzero((windows == tail).all(axis=1))
        if not hits.size:
            return []
        i = int(hits[-1])
        return [int(t) for t in ctx[i + n:i + n + k]]

    def _speculative_step(self, seq: SequenceDescriptor) -> None:
        """Verify [last_token, p1..pk] in one chunk forward: row i's argmax
        predicts position ctx+i, so accept p_{i+1} while it matches, then
        emit the first mismatch's argmax as the bonus/corrected token."""
        if not self.config.greedy:
            raise ValueError("speculative decoding is greedy-only: "
                             "proposal acceptance compares argmax chains")
        proposed = self._propose(seq)[:31]   # bucket ladder caps rows at 32
        if not proposed:
            self.step()
            return
        last = seq.generated[-1] if seq.generated else \
            int(seq.prompt_tokens[-1])
        ctx = seq.total_tokens                    # last's position is ctx-1
        true_len = 1 + len(proposed)
        bucket = snap_bucket(true_len, (8, 16, 32))
        self._ensure_blocks(seq, ctx + true_len)
        mb = self._ctx_bucket_blocks(ctx + true_len)
        tokens = np.zeros((bucket,), np.int32)
        tokens[0] = last
        tokens[1:true_len] = proposed
        logits, _ = verify_chunk_g(
            self.params, self._cache(), self._upload(tokens), ctx - 1,
            self._upload(self._block_table(seq, mb)), true_len,
            policy=self.policy, cfg=self.model_config,
            block_size=self.kv.cfg.block_size,
            attn_impl=self.config.attn_impl)
        preds = torch.argmax(logits[:true_len], dim=-1).cpu().numpy()
        emitted = []
        for i, p in enumerate(proposed):
            if int(preds[i]) == p:
                emitted.append(p)               # accepted proposal token
            else:
                break
        emitted.append(int(preds[len(emitted)]))  # bonus / corrected token
        appended = 0
        for tok in emitted:
            seq.generated.append(tok)
            appended += 1
            if self.config.eos_token_id is not None and \
                    tok == self.config.eos_token_id:
                seq.done = True
                break
        self._spec_proposed += len(proposed)
        self._spec_accepted += min(appended, len(emitted) - 1)
        self._spec_steps += 1
        seq.seen_tokens = seq.total_tokens - 1    # last emitted has no KV yet

    def speculative_stats(self) -> Dict[str, float]:
        """{steps, proposed, accepted, tokens_per_step}."""
        return {"steps": self._spec_steps, "proposed": self._spec_proposed,
                "accepted": self._spec_accepted,
                "tokens_per_step": (self._spec_accepted + self._spec_steps)
                / max(self._spec_steps, 1)}
