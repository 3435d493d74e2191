"""Host→device prefetch: overlap batch preparation with device compute.

Replaces pykaldi2_tpu/data/prefetch.py:device_prefetch. A background thread
builds the numpy batches, pins them and copies them to the device with
``non_blocking=True`` on a side CUDA stream; the consumer's stream waits on
the copy's event before it uses a batch, so the step never waits on the host.
On the CPU the arrays are only wrapped as tensors. ``device_batches`` is the
same without the thread, for consumers that capture CUDA graphs.

Spans (utils/tracing.py): ``pk2/loader.batch`` around building one host
batch and moving it (on the worker thread, or the caller's for
``device_batches``), ``pk2/loader.wait`` around the consumer's wait for the
worker.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from pykaldi2_tpu_torch.utils import tracing

_SENTINEL = object()


def device_prefetch(
    batches: Iterable[dict],
    device: torch.device,
    size: int = 2,
) -> Iterator[dict]:
    """Wrap a host batch iterator with a prefetch queue and device copies.

    Every numpy-array value goes to the device; host-side entries like
    ``utt_ids`` pass through.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    copy_stream = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(batch: dict):
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(np.ascontiguousarray(v))
                if cuda:
                    t = t.pin_memory().to(device, non_blocking=True)
                out[k] = t
            else:
                out[k] = v
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(copy_stream)
        return out, event

    err: list = []

    def worker():
        try:
            if cuda:
                torch.cuda.set_device(device)
            with torch.cuda.stream(copy_stream) if cuda else contextlib.nullcontext():
                it = iter(batches)
                while True:
                    with tracing.span("pk2/loader.batch"):
                        b = next(it, _SENTINEL)
                        item = b if b is _SENTINEL else put(b)
                    if item is _SENTINEL:
                        return
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
        except Exception as e:  # surface loader errors on the consumer side
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            with tracing.span("pk2/loader.wait"):
                item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            batch, event = item
            if cuda:
                cur = torch.cuda.current_stream(device)
                cur.wait_event(event)
                for v in batch.values():
                    if torch.is_tensor(v):
                        v.record_stream(cur)  # allocated on the copy stream, used here
            yield batch
    finally:
        stop.set()
        while t.is_alive():
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        t.join()



def device_batches(batches: Iterable[dict], device: torch.device) -> Iterator[dict]:
    """The batches' numpy arrays moved to ``device`` on the calling thread,
    one batch at a time: for a consumer that captures CUDA graphs (the device
    search), which no other thread's CUDA work may meet mid-capture."""
    it = iter(batches)
    while True:
        with tracing.span("pk2/loader.batch"):
            batch = next(it, _SENTINEL)
            if batch is _SENTINEL:
                return
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                   if isinstance(v, np.ndarray) else v for k, v in batch.items()}
        yield out
