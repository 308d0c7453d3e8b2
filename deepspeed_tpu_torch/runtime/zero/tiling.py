"""Tiled linear layers: a large matmul split into weight tiles.

Port of ``deepspeed_tpu/runtime/zero/tiling.py`` (reference
``deepspeed/runtime/zero/tiling.py:32``, ``TiledLinear``: a Linear split
into input- and output-feature tiles so ZeRO-3 fetches one tile at a
time). The parameters keep the flax module's names and layout: ``kernel``
``[in_splits, out_splits, in / in_splits, out / out_splits]`` and
``bias`` ``[features]``, so a flax tree loads as it is. The forward
accumulates one input tile's product at a time in ``dtype``, as the
reference's ``lax.scan`` over the input tiles does. No path of either
package calls it.
"""

import math

import torch


class TiledLinear(torch.nn.Module):
    """y = x @ W (+ b) with W held as (in_splits x out_splits) tiles."""

    def __init__(self, in_features: int, features: int, in_splits: int = 1,
                 out_splits: int = 1, use_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 seed: int = 0):
        super().__init__()
        if in_features % in_splits or features % out_splits:
            raise ValueError(
                f"features {in_features}->{features} not divisible by splits "
                f"({in_splits}, {out_splits})")
        self.in_features, self.features = in_features, features
        self.in_splits, self.out_splits = in_splits, out_splits
        self.dtype = dtype
        ti, to = in_features // in_splits, features // out_splits
        gen = torch.Generator().manual_seed(seed)
        # a normal kernel of variance 1 / in_features from ``seed`` (not
        # flax's initializer: a flax tree is loaded for the reference's)
        kernel = torch.randn((in_splits, out_splits, ti, to), generator=gen)
        self.kernel = torch.nn.Parameter(
            (kernel / math.sqrt(ti * in_splits)).to(device))
        self.bias = torch.nn.Parameter(
            torch.zeros(features, device=device)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.in_features:
            raise ValueError(f"input features {x.shape[-1]}, expected "
                             f"{self.in_features}")
        ti = self.in_features // self.in_splits
        to = self.features // self.out_splits
        xt = x.reshape(*x.shape[:-1], self.in_splits, ti)
        acc = torch.zeros((*x.shape[:-1], self.out_splits, to),
                          dtype=self.dtype, device=x.device)
        for i in range(self.in_splits):
            acc = acc + torch.einsum("...i,oij->...oj",
                                     xt[..., i, :].to(self.dtype),
                                     self.kernel[i].to(self.dtype))
        y = acc.reshape(*x.shape[:-1], self.features)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


def split_tiled_weight(full_kernel: torch.Tensor, in_splits: int,
                       out_splits: int) -> torch.Tensor:
    """A dense [D_in, D_out] kernel as ``TiledLinear``'s [in_splits,
    out_splits, ti, to] stack (reference ``TiledLinear.copy_params_from``)."""
    d_in, d_out = full_kernel.shape
    ti, to = d_in // in_splits, d_out // out_splits
    k = full_kernel.reshape(in_splits, ti, out_splits, to)
    return k.permute(0, 2, 1, 3).contiguous()
