"""Bounded staging buffers between the card and host memory.

The memory tiers move every gradient down and every weight up each step.
A copy between the card and pageable host memory runs synchronously and
slowly, and pinning tens of GB of optimizer state is not an option, so the
copies go through a few fixed buffers of ``STAGING_ELEMS`` elements, one a
dtype and direction, pinned when the device is a card and the tier's
``pin_memory`` is set. Each copy waits for itself before the buffer is used
again: the buffers are never refilled while a copy still reads them. A
process pins its own buffers: over ranks each rank has its ring, so two
ranks on one card hold two (host RAM the smoke's tier phases plan for).
"""

from typing import Dict, Tuple

import torch

STAGING_ELEMS = 1 << 26        # 256 MB of fp32 a buffer; a power of two, as
                               # the pinned allocator rounds up to one


class Staging:
    def __init__(self, device: torch.device, pin_memory: bool = True,
                 elems: int = STAGING_ELEMS):
        self.device = device
        self.pin = bool(pin_memory) and device.type == "cuda"
        self.elems = int(elems)
        self._bufs: Dict[Tuple[str, torch.dtype], torch.Tensor] = {}

    def _buf(self, way: str, dtype: torch.dtype) -> torch.Tensor:
        buf = self._bufs.get((way, dtype))
        if buf is None:
            buf = torch.empty(self.elems, dtype=dtype, pin_memory=self.pin)
            self._bufs[(way, dtype)] = buf
        return buf

    def _wait(self) -> None:
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()

    def down(self, src: torch.Tensor) -> torch.Tensor:
        """A flat device tensor of at most ``elems`` elements -> a host view
        of the staging buffer holding its values (valid until the next
        ``down`` of that dtype)."""
        n = src.numel()
        host = self._buf("down", src.dtype)[:n]
        host.copy_(src.view(-1), non_blocking=True)
        self._wait()
        return host

    def up_buffer(self, dtype: torch.dtype, n: int) -> torch.Tensor:
        """The first ``n`` (at most ``elems``) elements of the upward buffer
        of ``dtype``, for the caller to fill and then pass to ``up``."""
        return self._buf("up", dtype)[:n]

    def up(self, dst: torch.Tensor, filled: torch.Tensor) -> None:
        """The filled ``up_buffer`` view -> the flat device tensor ``dst``."""
        dst.view(-1).copy_(filled, non_blocking=True)
        self._wait()

    def to_host(self, t: torch.Tensor, dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
        """A new contiguous CPU tensor of ``t``'s values in ``dtype``, copied
        down a buffer at a time (``t`` itself cast when it is on the CPU)."""
        if t.device.type == "cpu":
            return t.detach().to(dtype).contiguous()
        out = torch.empty(t.shape, dtype=dtype)
        flat, src = out.view(-1), t.detach().reshape(-1)
        for a in range(0, src.numel(), self.elems):
            b = min(a + self.elems, src.numel())
            flat[a:b].copy_(self.down(src[a:b]))
        return out


class PinnedHost:
    """A flat CPU tensor of ``numel`` elements of ``dtype``, page-locked
    with ``cudaHostRegister`` when ``pin`` (no power-of-two rounding, as
    the caching pinned allocator has): the home of a tier's streamed
    weights. ``close`` (or collection) unregisters it; views that outlive
    it stay valid, as pageable memory."""

    def __init__(self, numel: int, dtype: torch.dtype, pin: bool):
        self.tensor = torch.empty(int(numel), dtype=dtype)
        self._ptr = None
        if pin and numel:
            rc = int(torch.cuda.cudart().cudaHostRegister(
                self.tensor.data_ptr(),
                self.tensor.numel() * self.tensor.element_size(), 0))
            if rc != 0:
                raise RuntimeError(f"cudaHostRegister failed (error {rc}) "
                                   f"for {self.tensor.numel()} x {dtype}")
            self._ptr = self.tensor.data_ptr()

    def close(self) -> None:
        if self._ptr is not None:
            torch.cuda.cudart().cudaHostUnregister(self._ptr)
            self._ptr = None

    def __del__(self):
        try:
            self.close()
        except Exception:       # interpreter teardown: CUDA may be gone
            pass
