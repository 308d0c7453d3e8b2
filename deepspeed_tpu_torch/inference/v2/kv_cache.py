"""Paged (blocked) KV cache on the device.

Port of ``deepspeed_tpu/inference/v2/kv_cache.py``. The pool is head-major
``[L, 2(kv), Hkv, num_blocks, block_size, d]``, so one page of one KV head
is a contiguous ``(block_size, d)`` tile, the unit the paged-attention
kernel reads. The last block is the trash page: padding tokens write there
and the allocator never hands it out.

The reference writes pages functionally (``.at[].set``); the port writes
the pool in place (``index_put_`` on views of it), which keeps one copy of
the pool on the device.
"""

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.inference.v2.blocked_allocator import BlockedAllocator


@dataclasses.dataclass
class KVCacheConfig:
    num_layers: int
    num_kv_heads: int
    head_dim: int
    block_size: int = 64
    num_blocks: int = 256
    dtype: torch.dtype = torch.bfloat16


class BlockedKVCache:
    def __init__(self, cfg: KVCacheConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        # last block reserved as the trash target for padding-token writes;
        # never handed out by the allocator
        self.allocator = BlockedAllocator(cfg.num_blocks - 1)
        self.data = torch.zeros(
            (cfg.num_layers, 2, cfg.num_kv_heads, cfg.num_blocks,
             cfg.block_size, cfg.head_dim), dtype=cfg.dtype, device=device)
        # fp8 pages carry a per-(layer, k/v, head, page) fp32 scale: stored
        # value = real / scale, grown monotonically as outliers arrive (the
        # whole page is requantized under the new scale on growth)
        self.scales = (torch.ones(
            (cfg.num_layers, 2, cfg.num_kv_heads, cfg.num_blocks),
            dtype=torch.float32, device=device)
            if cfg.dtype == torch.float8_e4m3fn else None)

    @property
    def free_blocks(self) -> int:
        return self.allocator.free_blocks

    def blocks_needed(self, num_tokens: int) -> int:
        return -(-int(num_tokens) // self.cfg.block_size)

    def reserve(self, num_blocks: int) -> List[int]:
        return self.allocator.allocate(num_blocks)

    def release(self, blocks: List[int],
                pinned: Optional[Sequence[int]] = None) -> None:
        """Free blocks back to the allocator. ``pinned`` names pages the
        prefix cache still holds readers on: those are skipped entirely —
        not freed and not scale-reset (a reset would re-interpret the
        surviving readers' stored values under the wrong scale)."""
        if pinned:
            keep = set(pinned)
            blocks = [b for b in blocks if b not in keep]
        self.allocator.free(blocks)
        if self.scales is not None and blocks:
            # a page freed by a sequence with outlier K/V must not impose
            # its grown scale on the next sequence that gets it
            idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
            self.scales[:, :, :, idx] = 1.0

    # ------------------------------------------------------------------
    # host offload tier (serving demotion/promotion; see kv_offload.py)
    # ------------------------------------------------------------------
    def gather_blocks(self, blocks: List[int]
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Copy the listed blocks' pages (and, for fp8, their scales) to
        host tensors ``[L, 2, H_kv, len(blocks), bs, D]``: a deliberate
        device-to-host copy, made only when a sequence is demoted."""
        idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
        data = self.data[:, :, :, idx].cpu()
        scales = (self.scales[:, :, :, idx].cpu()
                  if self.scales is not None else None)
        return data, scales

    def scatter_blocks(self, blocks: List[int], data: torch.Tensor,
                       scales: Optional[torch.Tensor] = None) -> None:
        """Write gathered pages back into (possibly other) blocks, the
        promotion path; fp8 scales are restored with them."""
        idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
        self.data[:, :, :, idx] = data.to(self.device, self.cfg.dtype)
        if self.scales is not None and scales is not None:
            self.scales[:, :, :, idx] = scales.to(self.device, torch.float32)


FP8_MAX = 448.0     # float8_e4m3fn max finite; overflow casts become NaN


def cast_to_page_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast K/V to the page dtype; fp8 pages clamp to the finite e4m3 range
    first (e4m3 has no inf: out-of-range casts would write NaN)."""
    if dtype == torch.float8_e4m3fn:
        x = x.clamp(-FP8_MAX, FP8_MAX)
    return x.to(dtype)


def write_kv(pool: torch.Tensor, layer: int, kv: int, vals: torch.Tensor,
             block_ids: torch.Tensor, offsets: torch.Tensor) -> None:
    """In place: token j of ``vals`` [T, Hkv, d] goes to page
    ``block_ids[j]``, slot ``offsets[j]`` of every KV head. Written as
    ``index_put_`` on the ``[NB, bs, Hkv, d]`` view of the layer's pages,
    whose indexed shape is ``[T, Hkv, d]`` like ``vals``; the reference's
    ``cache.at[i, kv, :, blk, off].set(...)`` puts the advanced dims first
    in the same way. Duplicate targets occur only on the trash page, where
    any writer may win."""
    view = pool[layer, kv].permute(1, 2, 0, 3)
    view.index_put_((block_ids, offsets), cast_to_page_dtype(vals, pool.dtype))


def write_kv_scaled(pool: torch.Tensor, scales: torch.Tensor, layer: int,
                    kv: int, vals: torch.Tensor, block_ids: torch.Tensor,
                    offsets: torch.Tensor, touched_pages: torch.Tensor
                    ) -> None:
    """In place: scatter new tokens into fp8 pages under per-(head, page)
    scales.

    pool: [L, 2, H, NB, bs, D] fp8; scales: [L, 2, H, NB] fp32; vals:
    [T, H, D]; block_ids/offsets: [T] target slot per token; touched_pages:
    [P] page ids covering ``set(block_ids)`` (duplicates allowed only with
    identical updates).

    A token whose |value| exceeds its page's committed range grows the page
    scale (``new = max(old, absmax/448)``) and the page is requantized under
    it. The reference decides on the host (``lax.cond``) whether any scale
    grew; here that would be a device-to-host sync per layer per step, so
    the requantize always runs on the touched pages: where no scale grew the
    ratio is exactly 1 and the fp8 -> fp32 -> fp8 round trip is exact."""
    f32 = torch.float32
    old_s = scales[layer, kv]                                   # [H, NB]
    absmax = vals.to(f32).abs().amax(dim=-1)                    # [T, H]
    h = old_s.shape[0]
    page_max = torch.zeros_like(old_s).scatter_reduce_(
        1, block_ids.long()[None, :].expand(h, -1), absmax.T.contiguous(),
        reduce="amax", include_self=True)
    # the trash page (where bucket-padding rows land) is never allocated or
    # released: letting it join the max would grow its scale for the life
    # of the cache with no effect on any output
    page_max[:, -1] = 0.0
    new_s = torch.maximum(old_s, page_max / FP8_MAX)            # [H, NB]

    pages = pool[layer, kv]                                     # [H, NB, bs, D]
    touched = touched_pages.long()
    ratio = (old_s / new_s)[:, touched]                         # [H, P]
    tile = pages[:, touched].to(f32) * ratio[..., None, None]
    pages[:, touched] = cast_to_page_dtype(tile, pool.dtype)
    tok_scale = new_s[:, block_ids.long()].T                    # [T, H]
    write_kv(pool, layer, kv, vals.to(f32) / tok_scale[..., None],
             block_ids.long(), offsets.long())
    old_s.copy_(new_s)
