"""Background batch preparation (counterpart of the JAX package's
data/prefetch.py).

One worker thread keeps `depth` host batches ready (the camera draw, the
native or numpy sampling, pinned tensors); the main thread issues their
non-blocking copies to the device in `next_train`, so they queue on the
stream the train step runs on. The worker draws in the order the datamanager would, so a prefetched run
trains on exactly the batches an unprefetched one does.
"""

from __future__ import annotations

import queue
import threading

from gaussiangrasper_torch.data.manager import FullImageDatamanager


class PrefetchingDatamanager:
    """Wraps a FullImageDatamanager; a worker thread keeps `depth` host
    batches ready so the card never waits on sampling or IO."""

    def __init__(self, dm: FullImageDatamanager, depth: int = 2):
        self.dm = dm
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._fill, daemon=True)
        self._worker.start()

    def _fill(self) -> None:
        while not self._stop.is_set():
            try:
                item = self.dm.next_train_host()
            except BaseException as e:  # propagate instead of dying silently
                item = e
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.25)
                    break
                except queue.Full:
                    continue
            if isinstance(item, BaseException):
                return

    def next_train(self):
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        idx, host = item
        return idx, self.dm.camera(idx), self.dm.to_device(host)

    def __len__(self) -> int:
        return len(self.dm)

    def __getattr__(self, name):
        return getattr(self.dm, name)

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._worker.join(timeout=2.0)
