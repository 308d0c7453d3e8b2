"""Async file I/O over the native thread-pool engine of ``csrc/aio.cpp``.

Port of ``deepspeed_tpu/ops/async_io.py`` (reference
``csrc/aio/py_lib/py_ds_aio.cpp``, ``aio_handle``): submit ``pread`` and
``pwrite`` of CPU tensors against files on NVMe, then poll, wait or drain.
The library is a copy of the JAX package's source, built by ``g++
-pthread`` on first use (``ops/build.py``); a failed build raises, and
there is no Python thread-pool fallback.

The handle keeps a reference to each request's tensor until the request is
waited or drained, so a caller cannot free a buffer the engine still reads
or writes.
"""

import ctypes
from typing import Dict

import torch

from deepspeed_tpu_torch.ops import build


class AsyncIOHandle:
    """reference: aio_handle(block_size, queue_depth, single_submit,
    overlap_events, num_threads); only ``num_threads`` is meaningful."""

    def __init__(self, num_threads: int = 8):
        self.num_threads = num_threads
        lib = build.load("aio")
        lib.aio_create.restype = ctypes.c_void_p
        lib.aio_create.argtypes = [ctypes.c_int]
        lib.aio_destroy.restype = None
        lib.aio_destroy.argtypes = [ctypes.c_void_p]
        for fn in (lib.aio_pread, lib.aio_pwrite):
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int64]
        for fn in (lib.aio_wait, lib.aio_is_done):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.aio_drain.restype = ctypes.c_int
        lib.aio_drain.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._h = lib.aio_create(num_threads)
        self._buffers: Dict[int, torch.Tensor] = {}   # request id -> tensor

    def close(self) -> None:
        """Wait for every request, then stop the engine's threads."""
        if self._h:
            self._lib.aio_drain(self._h)
            self._lib.aio_destroy(self._h)
            self._h = None
            self._buffers.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:       # interpreter teardown: the library may be gone
            pass

    @staticmethod
    def _check(t: torch.Tensor) -> None:
        if t.device.type != "cpu" or not t.is_contiguous():
            raise ValueError("async I/O takes contiguous CPU tensors, got "
                             f"{t.device} contiguous={t.is_contiguous()}")

    def _submit(self, fn, t: torch.Tensor, path: str, offset: int) -> int:
        self._check(t)
        rid = int(fn(self._h, path.encode(), t.data_ptr(),
                     t.numel() * t.element_size(), offset))
        self._buffers[rid] = t
        return rid

    def async_pwrite(self, t: torch.Tensor, path: str, offset: int = 0) -> int:
        return self._submit(self._lib.aio_pwrite, t, path, offset)

    def async_pread(self, t: torch.Tensor, path: str, offset: int = 0) -> int:
        return self._submit(self._lib.aio_pread, t, path, offset)

    def wait(self, request_id: int) -> int:
        """Block until the request completes; 0 = success, 1 = THIS request
        failed."""
        rc = int(self._lib.aio_wait(self._h, request_id))
        self._buffers.pop(request_id, None)
        return rc

    def is_done(self, request_id: int) -> bool:
        return bool(self._lib.aio_is_done(self._h, request_id))

    def drain(self) -> int:
        """Block until all outstanding requests complete; returns the number
        of failures among requests not individually waited (the count
        resets)."""
        failures = int(self._lib.aio_drain(self._h))
        self._buffers.clear()
        return failures
