"""Device selection for the port's entry points, and the host-to-device
uploads that never wait for the card (``upload``, ``PinnedStaging``).

Every entry point takes an explicit ``device`` that defaults to CUDA. The
CPU runs only when the caller asks for it (the CPU tests do): a missing
card is an error, never a silent fallback.

Which upload: ``upload`` everywhere, except where a CUDA graph captured
over the device tensors needs them at fixed addresses. Only there, and
only for a bounded set of shapes (ragged chunk buckets), ``PinnedStaging``
keeps buffers per shape, for as long as it lives.
"""

from __future__ import annotations

from typing import Callable

import torch


class ReplicaShared:
    """Mixin for an object that every worker replica of an operator shares
    by identity (a UDF or embedder, an index on the card, a CUDA graph,
    pinned buffers): ``Operator.replicate`` deep-copies the operator, and
    such an object deep-copies to itself."""

    def __deepcopy__(self, memo):
        return self


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a torch.device, after checking it can be used.

    For a CUDA device this also sets the numerics the port is held to:
    float32 matrix products in full float32 (no TF32, for cuBLAS and
    cuDNN alike) and bf16 products without reduced-precision reductions,
    so the KNN scores and the encoder's f32 path match the JAX package's
    float32 arithmetic. A CUDA device comes back with its index ("cuda"
    -> "cuda:<current>"), so it compares equal to the device of the
    tensors made on it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pathway_tpu_torch runs on an "
                "NVIDIA GPU by default; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A CPU tensor on ``device`` without a host wait: on a CUDA device
    the values go through a pinned copy (PyTorch's caching host allocator,
    which keeps the block until the copy has run) and a ``non_blocking``
    copy on the current stream. A blocking copy out of pageable memory
    would make the host wait for the whole stream. On the CPU the tensor
    itself."""
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class _Done:
    """An event that is always complete: the CPU's copies finish before
    ``upload`` returns."""

    def record(self) -> None:
        pass

    def synchronize(self) -> None:
        pass


class PinnedStaging(ReplicaShared):
    """Host arrays into fixed device tensors, with no host wait: for the
    inputs of a captured CUDA graph over a bounded set of shapes only (it
    never frees a shape's buffers; any other upload is ``upload``'s).

    ``upload(arrays)`` copies a tuple of numpy arrays into the device
    tensors kept for their shapes and dtypes: the same tensors at every call
    with those shapes, so a CUDA graph captured over them reads each call's
    data. On a CUDA device the arrays go through pinned host buffers and
    ``non_blocking`` copies on the current stream (a copy from pageable
    memory would make PyTorch wait for the stream). ``depth`` sets of host
    buffers take turns; an event recorded after a set's copies is waited on
    before the set is written again, so a buffer is never rewritten while
    its copy is still queued, and the host runs up to ``depth`` uploads
    ahead of the card. On the CPU the buffers are plain memory and
    ``event()`` (default: always complete) stands in for the CUDA event.
    The device tensors are shared by every call with their shapes, so the
    caller serializes an upload with the work that reads it (the graphed
    ingest step runs under its index's lock)."""

    def __init__(self, device: torch.device, depth: int = 2,
                 event: Callable | None = None):
        self.device = torch.device(device)
        self.depth = depth
        self._pin = self.device.type == "cuda"
        self._event = event or (torch.cuda.Event if self._pin else _Done)
        self._sets: dict[tuple, list] = {}

    def _new_set(self, arrays) -> list:
        host = [[torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                             pin_memory=self._pin) for a in arrays]
                for _ in range(self.depth)]
        dev = tuple(torch.empty(h.shape, dtype=h.dtype, device=self.device)
                    for h in host[0])
        # [host buffer sets, their events, device tensors, next set]
        return [host, [None] * self.depth, dev, 0]

    def upload(self, arrays) -> tuple[torch.Tensor, ...]:
        """The device tensors for ``arrays``' shapes, holding their values
        once the copies queued here have run."""
        key = tuple((a.shape, a.dtype.str) for a in arrays)
        st = self._sets.get(key)
        if st is None:
            st = self._sets[key] = self._new_set(arrays)
        host, events, dev, i = st
        st[3] = (i + 1) % self.depth
        if events[i] is not None:
            events[i].synchronize()  # this set's last copies have run
        for h, a in zip(host[i], arrays):
            h.numpy()[...] = a
        for d, h in zip(dev, host[i]):
            d.copy_(h, non_blocking=True)
        events[i] = self._event()
        events[i].record()
        return dev
