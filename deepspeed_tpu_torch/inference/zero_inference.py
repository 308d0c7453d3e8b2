"""ZeRO-Inference: weight-only quantization and host weight offload.

Port of ``deepspeed_tpu/inference/zero_inference.py``:

- ``quantize_model_params`` replaces every floating leaf of at least two
  dimensions (optionally only those whose ``/``-joined path matches one of
  ``modules``) by a ``QuantizedTensor``: the leaf flattened in its own
  element order, padded to whole groups of ``group_size`` and quantized per
  group. ``fmt="int"`` quantizes with plain torch ops on the leaf's device
  (the reference uses numpy; the values are the same), ``q_bits=4`` packs
  two codes per byte; ``fmt="fp"`` goes through ``FPQuantizer``: 8 bits is
  the fp8 e4m3 kernel (``ops/fp_quant.py``), 6 and 12 the packed software
  formats.
- ``dequantize_model_params`` inverts it: int8 and fp8 codes go through the
  dequantize kernels (``(float(q) * scale)`` in ``dtype`` over the
  ``[groups, group_size]`` codes, then the same unpad and reshape as the
  reference, which computes the identical function), int4 and fp6/fp12 stay
  plain torch, as in the reference.
- ``ZeROInferenceEngine``, resident (``offload="none"``: the store on the
  card, ``forward`` runs the training model's forward on the weights
  dequantized to ``dtype``, ``generate`` serves them through
  ``InferenceEngineV2``) or host-offloaded (``offload="cpu"``: the store in
  pinned host memory, streamed to the card layer by layer, each layer's
  copy on a side stream while the previous layer computes, with a host KV
  cache in power-of-two buckets for incremental generation).

Parameter trees are the port's nested dicts with the flax tree's names and
layouts (``models/convert.py``), so groups and scales match the
reference's. ``quantized_tree_from_jax`` turns the reference's quantized
store (numpy codes and scales) into the port's.
"""

import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.llama_decode import _mlp, _qkv, _rms
from deepspeed_tpu_torch.inference.v2.modules import _rope_tables
from deepspeed_tpu_torch.models.llama import (LlamaConfig, LlamaModel,
                                              _xla_attention, apply_rope,
                                              softcap_logits)
from deepspeed_tpu_torch.ops.fp_formats import FPQuantizer
from deepspeed_tpu_torch.ops.fp_quant import dequantize_fp8
from deepspeed_tpu_torch.ops.quant import dequantize_int8
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.logging import log_dist


class QuantizedTensor:
    """Quantized codes and fp32 group scales ``[groups, 1]`` of one leaf,
    with its original shape and its format ("int8" | "int4" | "fp6" |
    "fp8" | "fp12"). fp6/fp12 codes are the densely bit-packed uint8
    buffers of ``ops.fp_formats``; int4 codes two nibbles per byte; fp8
    codes ``torch.float8_e4m3fn``."""

    def __init__(self, codes: torch.Tensor, scale: torch.Tensor, shape,
                 fmt: str = "int8"):
        self.codes = codes
        self.scale = scale
        self.shape = tuple(int(s) for s in shape)
        self.fmt = fmt

    @property
    def nbytes(self) -> int:
        return _nbytes(self.codes) + _nbytes(self.scale)

    def apply(self, fn: Callable[[torch.Tensor], torch.Tensor]
              ) -> "QuantizedTensor":
        """The same record with ``fn`` applied to codes and scales."""
        return QuantizedTensor(fn(self.codes), fn(self.scale), self.shape,
                               self.fmt)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _map(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """Apply ``fn(path, leaf)`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _items(tree: Any, path: tuple = ()):
    """(path tuple, leaf) pairs of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, path + (k,))
    else:
        yield path, tree


def _leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in _items(tree)]


def quantize_model_params(params: Any, q_bits: int = 8, group_size: int = 64,
                          modules: Optional[Sequence[str]] = None,
                          fmt: str = "int") -> Any:
    """Group-wise symmetric weight-only quantization of a parameter tree
    (nested dicts of tensors). ``modules``: regexes of leaf paths to
    quantize (default: every floating leaf with ndim >= 2). Leaves are
    quantized where they lie."""
    return _map(_leaf_quantizer(q_bits, group_size, modules, fmt), params)


def _leaf_quantizer(q_bits: int, group_size: int,
                    modules: Optional[Sequence[str]], fmt: str
                    ) -> Callable[[tuple, torch.Tensor], Any]:
    """``(path, leaf) -> QuantizedTensor or the leaf unchanged``, after
    validating the options."""
    if fmt not in ("int", "fp"):
        raise ValueError(f"fmt must be 'int' or 'fp', got {fmt!r}")
    if fmt == "fp":
        if q_bits not in (6, 8, 12):
            raise ValueError("fp weight quantization supports q_bits 6, 8, 12")
        pack_group = {6: 4, 8: 1, 12: 2}[q_bits]
        if group_size % pack_group:
            raise ValueError(
                f"fp{q_bits} packs {pack_group} codes per unit: group_size "
                f"{group_size} must be divisible by {pack_group}")
    if fmt == "int" and q_bits == 4 and group_size % 2:
        raise ValueError(
            f"int4 packs two codes per byte: group_size {group_size} "
            f"must be even")
    pats = [re.compile(p) for p in (modules or [".*"])]
    qmax = 2.0 ** (q_bits - 1) - 1

    def quant(path, leaf):
        name = "/".join(str(k) for k in path)
        if (leaf.dim() < 2 or not leaf.is_floating_point()
                or not any(p.search(name) for p in pats)):
            return leaf
        flat = leaf.float().reshape(-1)
        pad = (-flat.numel()) % group_size
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        g = flat.reshape(-1, group_size)
        if fmt == "fp":
            codes, scale = FPQuantizer(q_bits).quantize(g)
            return QuantizedTensor(codes, scale.float(), leaf.shape,
                                   f"fp{q_bits}")
        # the reference quantizes with numpy here: a true division by qmax
        absmax = g.abs().amax(dim=1, keepdim=True)
        scale = torch.clamp_min(absmax / absmax.new_full((), qmax), 1e-12)
        codes = torch.clamp(torch.round(g / scale), -qmax - 1, qmax
                            ).to(torch.int8)
        if q_bits == 4:
            # nibble-pack: group_size is even (>= 2 codes per group row)
            c = (codes.to(torch.int32) + 8).reshape(codes.shape[0], -1, 2)
            packed = (c[:, :, 0] | (c[:, :, 1] << 4)).to(torch.uint8)
            return QuantizedTensor(packed, scale, leaf.shape, "int4")
        return QuantizedTensor(codes, scale, leaf.shape)

    return quant


def _dequantize_leaf(node: QuantizedTensor, dtype: torch.dtype
                     ) -> torch.Tensor:
    n = math.prod(node.shape)
    if node.fmt == "int4":
        packed = node.codes.to(torch.int32)
        lo = (packed & 0xF) - 8
        hi = (packed >> 4) - 8
        codes = torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], -1)
        flat = (codes.float() * node.scale).reshape(-1)
    elif node.fmt in ("fp6", "fp12"):
        bits = int(node.fmt[2:])
        d = node.codes.shape[-1] * 8 // bits
        flat = FPQuantizer(bits).dequantize(node.codes, node.scale, d=d,
                                            dtype=torch.float32).reshape(-1)
    elif node.fmt == "fp8":
        flat = dequantize_fp8(node.codes, node.scale, dtype).reshape(-1)
    else:   # int8 codes
        flat = dequantize_int8(node.codes, node.scale, dtype).reshape(-1)
    return flat[:n].reshape(node.shape).to(dtype)


def dequantize_model_params(qparams: Any, dtype: torch.dtype = torch.bfloat16
                            ) -> Any:
    """Inverse transform: every ``QuantizedTensor`` back to a tensor in
    ``dtype`` of its original shape; other leaves pass through."""
    return _map(lambda _, node: _dequantize_leaf(node, dtype)
                if isinstance(node, QuantizedTensor) else node, qparams)


def quantized_nbytes(qparams: Any) -> int:
    return sum(leaf.nbytes if isinstance(leaf, QuantizedTensor)
               else _nbytes(leaf) for leaf in _leaves(qparams))


def _from_numpy(arr, device: torch.device) -> torch.Tensor:
    """A numpy leaf of the reference (float8 and bfloat16 through
    ``ml_dtypes`` included) -> a tensor of the same dtype and bits."""
    a = np.array(arr)                        # own, writable, contiguous copy
    views = {"float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
             "float8_e5m2": (np.uint8, torch.float8_e5m2),
             "bfloat16": (np.uint16, torch.bfloat16)}
    if a.dtype.name in views:
        raw, dt = views[a.dtype.name]
        return torch.from_numpy(a.view(raw)).view(dt).to(device)
    return torch.from_numpy(a).to(device)


def quantized_tree_from_jax(tree: Any, device=None) -> Any:
    """The reference's quantized store (nested dicts whose quantized leaves
    carry ``codes``, ``scale``, ``shape`` and ``fmt``; numpy arrays) -> the
    port's, on ``device``."""
    dev = resolve_device(device)

    def conv(_, node):
        if all(hasattr(node, a) for a in ("codes", "scale", "shape", "fmt")):
            return QuantizedTensor(_from_numpy(node.codes, dev),
                                   _from_numpy(node.scale, dev), node.shape,
                                   node.fmt)
        return _from_numpy(node, dev)
    return _map(conv, dict(tree))


class ZeROInferenceEngine:
    """Weight-quantized (optionally host-offloaded, layer-streamed)
    inference over the Llama family's parameter tree.

    ``offload="none"``: the quantized store lives on the device; ``forward``
    dequantizes it and runs the model's forward. ``offload="cpu"``: the
    store stays in (pinned) host memory and ``forward``/``generate`` stream
    weights layer by layer. ``model`` is kept for the reference's signature
    (its config is used when ``model_config`` is None); its weights are not
    read. Runs on the card unless ``device="cpu"``."""

    def __init__(self, model, params, model_config: Optional[LlamaConfig] = None,
                 q_bits: int = 8, group_size: int = 64, offload: str = "none",
                 dtype: torch.dtype = torch.bfloat16,
                 modules: Optional[Sequence[str]] = None, fmt: str = "int",
                 device=None):
        if offload not in ("none", "cpu"):
            raise ValueError(f"offload must be 'none' or 'cpu', got {offload!r}")
        self.model = model
        self.cfg = model_config or getattr(model, "cfg", None)
        self.dtype = dtype
        self.offload = offload
        self.device = resolve_device(device)
        orig = sum(_nbytes(t) for t in _leaves(params))
        quant = _leaf_quantizer(q_bits, group_size, modules, fmt)

        def place(path, leaf):            # one leaf on the device at a time
            node = quant(path, leaf.to(self.device))
            if offload == "none":
                return node
            return node.apply(self._to_host) \
                if isinstance(node, QuantizedTensor) else self._to_host(node)
        self.qstore = _map(place, params)
        # bytes of the store streamed to the device by the offload path
        self.streamed_bytes = 0
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if offload == "cpu" and self.device.type == "cuda"
                             else None)
        self._model_fn: Optional[LlamaModel] = None
        log_dist(f"zero-inference: {orig / 1e6:.1f}MB fp -> "
                 f"{quantized_nbytes(self.qstore) / 1e6:.1f}MB quantized "
                 f"(q{q_bits}, offload={offload})", ranks=[0])

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A device tensor -> host memory (pinned when there is a card, so
        the layer copies can run on the side stream)."""
        if self.device.type != "cuda":
            return t
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)

    def _require_cfg(self, what: str) -> LlamaConfig:
        if self.cfg is None:
            raise ValueError(f"{what} needs a LlamaConfig-style model config")
        return self.cfg

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids), device=self.device).long()

    # -- resident path ------------------------------------------------------
    def forward(self, batch) -> torch.Tensor:
        """{"input_ids": [B, S]} -> fp32 logits [B, S, V]."""
        if self.offload == "cpu":
            return self._streamed_forward(batch)
        cfg = self._require_cfg("forward")
        if self._model_fn is None:        # the training model, without weights
            self._model_fn = LlamaModel(cfg, torch.device("meta"))
        weights = {".".join(path[1:]): t for path, t in _items(
            dequantize_model_params(self.qstore, self.dtype))}
        cos, sin = _rope_tables(cfg.head_dim_, cfg.max_seq_len,
                                cfg.rope_theta, self.device)
        weights.update(rope_cos=cos, rope_sin=sin)
        with torch.no_grad():
            return torch.func.functional_call(
                self._model_fn, weights, (self._ids(batch["input_ids"]),))

    # -- host-offloaded, layer-streamed path --------------------------------
    def _prefetch(self, tree):
        """Start copying a piece of the store to the device (on the side
        stream when there is a card); ``_arrive`` hands it over."""
        self.streamed_bytes += quantized_nbytes(tree)
        if self._copy_stream is None:
            return tree, None
        with torch.cuda.stream(self._copy_stream):
            dev = _map(lambda _, node: node.apply(self._upload)
                       if isinstance(node, QuantizedTensor)
                       else self._upload(node), tree)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return dev, done

    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, non_blocking=True)

    def _arrive(self, fetched):
        tree, done = fetched
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for leaf in _leaves(tree):     # made on the side stream, used here
                for t in ((leaf.codes, leaf.scale)
                          if isinstance(leaf, QuantizedTensor) else (leaf,)):
                    t.record_stream(stream)
        return tree

    def _fetch(self, tree):
        return self._arrive(self._prefetch(tree))

    def _stream_layers(self):
        """Yield each layer's weights on the device, dequantized; layer
        i + 1's copy is started before layer i is handed out."""
        m = self.qstore["model"]
        n = self.cfg.num_layers
        nxt = self._prefetch(m["layer_0"])
        for i in range(n):
            cur = nxt
            if i + 1 < n:
                nxt = self._prefetch(m[f"layer_{i + 1}"])
            yield dequantize_model_params(self._arrive(cur), self.dtype)

    def _embed(self):
        return dequantize_model_params(self._fetch(self.qstore["model"]["embed"]),
                                       self.dtype)

    def _tail(self):
        m = self.qstore["model"]
        tail = {"final_norm": m["final_norm"]}
        if "lm_head" in m:
            tail["lm_head"] = m["lm_head"]
        return dequantize_model_params(self._fetch(tail), self.dtype)

    def _embed_tokens(self, embed, ids: torch.Tensor) -> torch.Tensor:
        x = embed["embedding"][ids]
        if self.cfg.scale_embeddings:       # gemma normalizer
            x = x * torch.tensor(math.sqrt(self.cfg.hidden_size),
                                 dtype=torch.float32).to(x.dtype)
        return x

    def _streamed_forward(self, batch) -> torch.Tensor:
        """embed -> [stream layer i, run its block] -> final norm + head."""
        self._require_cfg("streamed forward")
        ids = self._ids(batch["input_ids"])
        with torch.no_grad():
            embed = self._embed()
            x = self._embed_tokens(embed, ids)
            positions = torch.arange(ids.shape[1], device=self.device)[None, :]
            for lp in self._stream_layers():
                x = self._block_kv(lp, x, positions)[0]
            return self._head(self._tail(), embed, x)

    def _norm(self, x, scale):
        off = 1.0 if self.cfg.rms_scale_offset else 0.0
        return _rms(x, scale + off, self.cfg.rms_norm_eps)

    def _rope(self):
        cfg = self.cfg
        return _rope_tables(cfg.head_dim_, cfg.max_seq_len, cfg.rope_theta,
                            self.device)

    def _mlp(self, lp, x):
        return _mlp(lp, x, act=self.cfg.hidden_act, dtype=self.dtype)

    def _block_kv(self, lp, x, positions):
        """One prefill block that also returns the layer's K/V [B,S,Hkv,hd]
        (plain attention, as the reference's ``_xla_attention``)."""
        cos, sin = self._rope()
        h = self._norm(x, lp["attn_norm"]["scale"])
        b, s, d = h.shape
        q, k, v = _qkv(lp, h.reshape(b * s, d), self.dtype)
        q = apply_rope(q.reshape(b, s, *q.shape[1:]), cos, sin, positions)
        k = apply_rope(k.reshape(b, s, *k.shape[1:]), cos, sin, positions)
        v = v.reshape(b, s, *v.shape[1:])
        attn = _xla_attention(q, k, v, causal=True,
                              window=self.cfg.sliding_window)
        x = x + torch.einsum("bshk,hkd->bsd", attn,
                             lp["attn"]["wo"]["kernel"].to(self.dtype))
        return x + self._mlp(lp, self._norm(x, lp["mlp_norm"]["scale"])), k, v

    def _block_decode(self, lp, x, pos, k_buf, v_buf, ctx_len: int):
        """A single-token block against a fixed-capacity KV buffer: writes
        the token's K/V at ``ctx_len`` (in place) and attends over positions
        ``<= ctx_len``."""
        cos, sin = self._rope()
        h = self._norm(x, lp["attn_norm"]["scale"])
        b, s, d = h.shape                                   # s == 1
        q, k, v = _qkv(lp, h.reshape(b * s, d), self.dtype)
        q = apply_rope(q.reshape(b, s, *q.shape[1:]), cos, sin, pos)
        k = apply_rope(k.reshape(b, s, *k.shape[1:]), cos, sin, pos)
        k_buf[:, ctx_len:ctx_len + 1] = k
        v_buf[:, ctx_len:ctx_len + 1] = v.reshape(b, s, *v.shape[1:])
        hq, hkv = q.shape[2], k_buf.shape[2]
        kq = k_buf.repeat_interleave(hq // hkv, dim=2) if hq != hkv else k_buf
        vq = v_buf.repeat_interleave(hq // hkv, dim=2) if hq != hkv else v_buf
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kq.float()
                              ) / math.sqrt(q.shape[-1])
        kpos = torch.arange(k_buf.shape[1], device=x.device)
        mask = kpos <= ctx_len
        if self.cfg.sliding_window:
            mask = mask & (kpos > ctx_len - self.cfg.sliding_window)
        scores = torch.where(mask, scores, -1e30)
        p = torch.softmax(scores, dim=-1).to(vq.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", p, vq)
        x = x + torch.einsum("bshk,hkd->bsd", attn,
                             lp["attn"]["wo"]["kernel"].to(self.dtype))
        return x + self._mlp(lp, self._norm(x, lp["mlp_norm"]["scale"]))

    def _head(self, tail, embed, x) -> torch.Tensor:
        x = self._norm(x, tail["final_norm"]["scale"])
        w = tail["lm_head"]["kernel"] if "lm_head" in tail \
            else embed["embedding"].T
        return softcap_logits(x.float() @ w.float(), self.cfg.logits_soft_cap)

    # -- generation ---------------------------------------------------------
    def generate(self, prompt_tokens: Sequence[int], max_new_tokens: int = 32
                 ) -> List[int]:
        """Greedy generation. Resident mode serves the dequantized weights
        through ``InferenceEngineV2`` (paged KV cache, the paged-attention
        kernel on the card); offload mode streams layer weights and a host
        KV cache per step."""
        if self.offload == "none" and self.cfg is not None:
            deq = dequantize_model_params(self.qstore, self.dtype)
            return InferenceEngineV2(deq, self.cfg, device=self.device).generate(
                list(prompt_tokens), max_new_tokens=max_new_tokens)
        return self._streamed_generate(list(prompt_tokens), max_new_tokens)

    def _host_kv(self, kv: torch.Tensor, cap: int) -> torch.Tensor:
        """A layer's K or V [B, S, Hkv, hd] -> a host buffer of ``cap``
        positions (pinned when there is a card), zero past S."""
        pin = self.device.type == "cuda"
        buf = torch.zeros((kv.shape[0], cap, *kv.shape[2:]), dtype=kv.dtype,
                          pin_memory=pin)
        buf[:, :kv.shape[1]].copy_(kv, non_blocking=pin)
        return buf

    def _streamed_generate(self, ids: List[int], max_new_tokens: int
                           ) -> List[int]:
        """Layer-streamed generation with a host KV cache, padded to
        power-of-two buckets (the reference's compile buckets; here they
        bound how often the host buffers are reallocated). Per decode step
        and layer, the layer's host K/V go to the device, the block writes
        the new token's K/V at ``ctx_len``, and that slot comes back. The
        host buffers are read again only after the step's token readback,
        which waits for every copy."""
        cfg = self._require_cfg("streamed generation")
        if max_new_tokens <= 0:
            return []

        def bucket(n):
            return 1 << max(4, (n - 1).bit_length())

        with torch.no_grad():
            embed = self._embed()
            x = self._embed_tokens(embed, self._ids([ids]))
            positions = torch.arange(len(ids), device=self.device)[None, :]
            cap = bucket(len(ids) + max_new_tokens // 2)
            host_kv = []
            for lp in self._stream_layers():
                x, k, v = self._block_kv(lp, x, positions)
                host_kv.append((self._host_kv(k, cap), self._host_kv(v, cap)))
            tail = self._tail()
            out = [int(torch.argmax(self._head(tail, embed, x)[0, -1]))]
            ids = ids + out[-1:]

            for _ in range(max_new_tokens - 1):
                ctx_len = len(ids) - 1             # the new token's write index
                if ctx_len + 1 > cap:              # grow the bucket
                    cap = bucket(ctx_len + 1)
                    host_kv = [(self._host_kv(k, cap), self._host_kv(v, cap))
                               for k, v in host_kv]
                pos = torch.tensor([[ctx_len]], device=self.device)
                x = self._embed_tokens(embed, self._ids([[ids[-1]]]))
                for i, lp in enumerate(self._stream_layers()):
                    k_host, v_host = host_kv[i]
                    k_buf = self._upload(k_host)
                    v_buf = self._upload(v_host)
                    x = self._block_decode(lp, x, pos, k_buf, v_buf, ctx_len)
                    if k_buf is not k_host:
                        k_host[:, ctx_len].copy_(k_buf[:, ctx_len],
                                                 non_blocking=True)
                        v_host[:, ctx_len].copy_(v_buf[:, ctx_len],
                                                 non_blocking=True)
                out.append(int(torch.argmax(self._head(tail, embed, x)[0, -1])))
                ids.append(out[-1])
        return out
