"""Token sampling for serving: greedy / temperature / top-k / top-p.

Port of ``deepspeed_tpu/inference/v2/sampling.py``. Sampling runs on the
engine's device, so a step moves only the [B] sampled ids to the host.
Draws come from a ``torch.Generator`` on that device (seeded from
``SamplingConfig.seed`` by the engine); its numbers differ from
``jax.random``'s for the same seed, so only greedy decoding is expected to
match the reference token for token.
"""

import dataclasses

import torch

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0     # 0 -> greedy argmax
    top_k: int = 0               # 0 -> disabled
    top_p: float = 1.0           # 1 -> disabled
    seed: int = 0


def sample_tokens(logits: torch.Tensor, generator: torch.Generator,
                  cfg: SamplingConfig) -> torch.Tensor:
    """logits: [B, V] -> [B] int32 sampled token ids (on logits' device)."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / cfg.temperature
    if cfg.top_k and cfg.top_k > 0:
        kth = torch.topk(scaled, cfg.top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, NEG_INF, scaled)
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative mass >= top_p; the top-1
        # token is kept unconditionally so top_p <= 0 degrades to greedy
        keep = cum - probs < cfg.top_p
        keep[:, 0] = True
        cutoff = torch.where(keep, sorted_logits, float("inf")).amin(
            dim=-1, keepdim=True)
        scaled = torch.where(scaled < cutoff, NEG_INF, scaled)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
