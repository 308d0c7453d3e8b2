"""Host-RAM KV offload store: the demotion tier under the device cache.

Port of ``deepspeed_tpu/inference/v2/kv_offload.py``. When device KV
blocks run hot, a sequence's pages are demoted to host RAM (freeing its
device blocks) and promoted back, possibly into other block ids, when
there is room again.

Demoted pages can be stored int8 or fp8 e4m3 with one fp32 scale per
(layer, k/v, head, page), the group shape of the device fp8 pages. Promotion
dequantizes back to the device page width: bit-identical for ``"none"``,
within ``quantize_error_bound`` for the quantized codecs. Pages that are
already fp8 on the device are never re-quantized.

The codecs are torch ops on host tensors (the reference's are numpy with
``ml_dtypes``); this module is the storage half only, the engine
(``InferenceEngineV2.demote_kv`` / ``promote_kv``) moves the pages.

The fleet's prefix-handoff file (``InferenceEngineV2.export_prefix_handoff``)
is an ``.npz`` of numpy arrays, as the reference's. numpy has no bfloat16
and no float8: ``to_handoff_array`` writes such pages as their raw bits
(``uint16`` / ``uint8``) with a dtype tag, and ``from_handoff_array``
restores them. fp32 pages, int8 codes and fp32 scales stay plain numpy, so
those files interchange with the reference's in both directions.
"""

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: host-tier page codecs the serving ``host_kv_quantize`` knob selects
KV_CODECS = ("none", "int8", "fp8")

_INT8_MAX = 127.0
_FP8_MAX = 448.0       # float8_e4m3fn max finite (see kv_cache.FP8_MAX)


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _page_absmax(data: torch.Tensor) -> torch.Tensor:
    """[L, 2, H, NB, bs, D] -> per-page absmax [L, 2, H, NB] in fp32."""
    return data.float().abs().amax(dim=(-1, -2))


def quantize_pages(data: torch.Tensor, codec: str
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Quantize gathered page tiles ``[L, 2, H, NB, bs, D]`` under the
    per-page group-scale scheme. Returns ``(stored, qscales)``:
    ``codec="none"`` passes through (qscales None); ``"int8"`` stores int8
    with fp32 scales ``absmax/127``; ``"fp8"`` stores float8_e4m3fn with
    fp32 scales ``absmax/448``. All-zero pages get scale 1.0 so the round
    trip stays exact."""
    if codec == "none":
        return data, None
    if codec not in KV_CODECS:
        raise ValueError(f"unknown KV page codec {codec!r}; "
                         f"one of {KV_CODECS}")
    limit = _INT8_MAX if codec == "int8" else _FP8_MAX
    scales = _page_absmax(data) / torch.tensor(limit)
    scales = torch.where(scales > 0.0, scales, 1.0).float()
    scaled = data.float() / scales[..., None, None]
    if codec == "int8":
        stored = torch.clamp(torch.round(scaled), -_INT8_MAX, _INT8_MAX
                             ).to(torch.int8)
    else:
        stored = torch.clamp(scaled, -_FP8_MAX, _FP8_MAX
                             ).to(torch.float8_e4m3fn)
    return stored, scales


def dequantize_pages(stored: torch.Tensor, qscales: Optional[torch.Tensor],
                     codec: str, out_dtype: torch.dtype) -> torch.Tensor:
    """Invert ``quantize_pages`` back to the device page dtype. For
    ``codec="none"`` this is the identity (bit-identical promotion)."""
    if codec == "none" or qscales is None:
        return stored
    return (stored.float() * qscales[..., None, None]).to(out_dtype)


#: dtypes numpy cannot hold, written to a handoff file as raw bits
_BITS_OF = {torch.bfloat16: torch.uint16, torch.float8_e4m3fn: torch.uint8}
_TAG_OF = {torch.bfloat16: "bfloat16", torch.float8_e4m3fn: "float8_e4m3fn"}
_DTYPE_OF_TAG = {tag: dt for dt, tag in _TAG_OF.items()}


def to_handoff_array(t: torch.Tensor) -> Tuple[np.ndarray, Optional[str]]:
    """A host tensor as a numpy array for the handoff file, and the dtype
    tag to store beside it (None when numpy holds the dtype itself)."""
    t = t.detach().cpu().contiguous()
    bits = _BITS_OF.get(t.dtype)
    if bits is None:
        return t.numpy(), None
    return t.view(bits).numpy(), _TAG_OF[t.dtype]


def from_handoff_array(a: np.ndarray, tag: Optional[str] = None
                       ) -> torch.Tensor:
    """Invert ``to_handoff_array``: raw bits under a dtype tag come back as
    that dtype. (The reference's own bf16/fp8 pages load as numpy void
    arrays, which torch refuses: the import skips such a chain.)"""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if tag is None:
        return t
    if tag not in _DTYPE_OF_TAG:
        raise ValueError(f"handoff array of unknown dtype tag {tag!r}")
    return t.view(_DTYPE_OF_TAG[tag])


def quantize_error_bound(qscales: Optional[torch.Tensor], codec: str) -> float:
    """The per-element absolute error bound of one quantize round trip:
    half a step (``scale/2``) for int8; for fp8 e4m3 (3 mantissa bits,
    half-ulp relative error 2^-4) ``scale * 448 * 2^-4``."""
    if codec == "none" or qscales is None:
        return 0.0
    s = float(qscales.max())
    return s * (0.5 if codec == "int8" else _FP8_MAX * 2.0 ** -4)


@dataclasses.dataclass
class HostKVEntry:
    """One demoted sequence's KV state: the gathered page tiles
    ``[L, 2, H_kv, n_blocks, block_size, D]`` (host tensor; full width, or
    codec-quantized with per-page ``qscales``) and the bookkeeping needed
    to re-reserve on promotion. fp8 device pages keep their per-(head,
    page) ``scales`` alongside either way."""

    blocks: int                               # device blocks held at demotion
    data: Optional[torch.Tensor]              # None when blocks == 0
    scales: Optional[torch.Tensor]            # fp8 device page scales
    seen_tokens: int                          # KV coverage at demotion
    codec: str = "none"                       # host-tier page codec
    qscales: Optional[torch.Tensor] = None    # codec scales (per page, fp32)
    raw_nbytes: int = 0                       # pre-codec bytes

    @property
    def nbytes(self) -> int:
        return _nbytes(self.data) + _nbytes(self.scales) + _nbytes(self.qscales)


class HostKVStore:
    """uid -> ``HostKVEntry`` with running byte and lifetime accounting:
    stored bytes (what counts against the host budget) and raw bytes (what
    the pages would cost at device width)."""

    def __init__(self):
        self._entries: Dict[int, HostKVEntry] = {}
        self.total_bytes = 0
        self.raw_bytes = 0
        # lifetime counters (monotone)
        self.demotions = 0
        self.promotions = 0
        self.demoted_bytes = 0
        self.promoted_bytes = 0
        self.demoted_raw_bytes = 0
        self.quantized_entries = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, uid: int) -> bool:
        return uid in self._entries

    def get(self, uid: int) -> Optional[HostKVEntry]:
        return self._entries.get(uid)

    def uids(self) -> List[int]:
        """Insertion (= demotion) order: the FIFO promotion order."""
        return list(self._entries)

    def put(self, uid: int, entry: HostKVEntry) -> int:
        if uid in self._entries:
            raise ValueError(f"uid {uid} already demoted")
        if entry.raw_nbytes == 0:
            entry.raw_nbytes = entry.nbytes
        self._entries[uid] = entry
        self.total_bytes += entry.nbytes
        self.raw_bytes += entry.raw_nbytes
        self.demotions += 1
        self.demoted_bytes += entry.nbytes
        self.demoted_raw_bytes += entry.raw_nbytes
        if entry.codec != "none":
            self.quantized_entries += 1
        return entry.nbytes

    def pop(self, uid: int, promoted: bool = False) -> Optional[HostKVEntry]:
        """Remove an entry (promotion, or flush of a cancelled sequence).
        ``promoted=True`` counts it as a promotion."""
        entry = self._entries.pop(uid, None)
        if entry is None:
            return None
        self.total_bytes -= entry.nbytes
        self.raw_bytes -= entry.raw_nbytes
        if promoted:
            self.promotions += 1
            self.promoted_bytes += entry.nbytes
        return entry

    def compression_ratio(self) -> float:
        """Lifetime demoted raw/stored ratio (1.0 = no quantization)."""
        return (self.demoted_raw_bytes / self.demoted_bytes
                if self.demoted_bytes > 0 else 1.0)
