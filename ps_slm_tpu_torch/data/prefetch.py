"""Background batch prefetching, with the host-to-device copy off the
consumer's thread.

Counterpart of ``ps_slm_tpu/data/prefetch.py``.  The host work of a batch
is IO and tokenization (fbank runs on the device), so one producer thread
with a bounded queue hides it behind the device step.

:func:`device_prefetch` also places each batch on the device inside the
producer thread.  On a CUDA device the copy is issued from pinned host
memory, ``non_blocking``, on a side stream, and an event recorded after it;
the consumer makes its current stream wait on that event before it
receives the batch and marks every tensor with ``record_stream``, so the
caching allocator does not hand the memory to another tensor while the
consumer's stream may still read it.  The copy of batch N+1 then overlaps
the step on batch N.  On the CPU the batch is converted to tensors.

The consumer's waits are spans ``data.wait`` (``utils/profiler.py``): the
queue's ``get`` and the stream's wait on the copy.  The producer thread has
none: a profiler started on the consumer's thread does not record it.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ps_slm_tpu_torch.utils.profiler import span

_SENTINEL = object()


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    """Wrap an iterable so items are produced by a daemon thread.

    Exceptions in the producer are re-raised at the consumer.
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    err = []

    def producer():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - reraised below
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        with span("data.wait"):
            item = q.get()
        if item is _SENTINEL:
            if err:
                raise err[0]
            return
        yield item


def as_tensor(v) -> torch.Tensor:
    """A host batch field (numpy array, tensor or scalar) as a CPU tensor,
    sharing the array's memory where it can."""
    return torch.from_numpy(v) if isinstance(v, np.ndarray) else torch.as_tensor(v)


def device_prefetch(
    iterable: Iterable[Dict], device, select: Callable[[Dict], Dict], depth: int = 2,
) -> Iterator[Tuple[Dict, Dict[str, torch.Tensor]]]:
    """Prefetch with host-to-device placement inside the producer thread
    (module docstring).  ``select(host_batch)`` gives the fields to place
    (arrays or tensors).

    Yields ``(host_batch, device_batch)`` pairs; host-only fields (keys,
    targets, audio seconds) stay readable on the host side.
    """
    dev = torch.device(device)
    side: Optional[torch.cuda.Stream] = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def place(batch: Dict):
        fields = {k: as_tensor(v) for k, v in select(batch).items()}
        if side is None:
            return batch, {k: t.to(dev) for k, t in fields.items()}, None
        with torch.cuda.stream(side):
            out = {k: t.pin_memory().to(dev, non_blocking=True) for k, t in fields.items()}
            ready = torch.cuda.Event()
            ready.record(side)
        return batch, out, ready

    for batch, out, ready in prefetch((place(b) for b in iterable), depth=depth):
        if ready is not None:
            with span("data.wait"):
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(ready)
                for t in out.values():
                    t.record_stream(consumer)
        yield batch, out
