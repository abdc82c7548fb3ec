"""Host frame feeder: decode-ahead pipeline for streamed tracking.

The counterpart of :mod:`glimpse_tpu.track.feeder`. Upstream preloads whole
image sequences into fork-shared memory before tracking. The streaming
equivalent here decodes and preprocesses frames on background threads
(Pillow decode and the native C++ grayscale conversion when built) one step
ahead of the device, so ``BatchTracker.track_stream`` overlaps host I/O with
the card's compute.
"""
import concurrent.futures
import datetime as datetime_module
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from .. import native


def load_frame(image, dtype=np.float32) -> np.ndarray:
    """Decode one observer image to grayscale float32 (native-accelerated)."""
    array = image.read(cache=False) if hasattr(image, "read") else np.asarray(image)
    if array.ndim == 3:
        if array.dtype == np.uint8:
            return native.gray_f32(array)
        return np.asarray(array, dtype=dtype).mean(axis=2)
    return np.asarray(array, dtype=dtype)


class FrameFeeder:
    """Iterate (O, H, W) frame stacks with background decode-ahead.

    Arguments:
        observers: One image sequence per observer (equal lengths, aligned
            in time).
        prefetch: Number of frames decoded ahead of consumption.
    """

    def __init__(self, observers: Sequence[Sequence], prefetch: int = 2) -> None:
        lengths = {len(obs) for obs in observers}
        if len(lengths) != 1:
            raise ValueError("Observer image sequences have different lengths")
        self.observers = observers
        self.n_frames = lengths.pop()
        self.prefetch = max(1, prefetch)

    def _load(self, t: int) -> np.ndarray:
        return np.stack([load_frame(obs[t]) for obs in self.observers])

    def __len__(self) -> int:
        return self.n_frames

    def __iter__(self) -> Iterator[np.ndarray]:
        with concurrent.futures.ThreadPoolExecutor(self.prefetch) as pool:
            pending = [
                pool.submit(self._load, t)
                for t in range(min(self.prefetch, self.n_frames))
            ]
            next_t = len(pending)
            for _ in range(self.n_frames):
                frame = pending.pop(0).result()
                if next_t < self.n_frames:
                    pending.append(pool.submit(self._load, next_t))
                    next_t += 1
                yield frame


def stream_track(tracker, generator, observers: Sequence[Sequence], dts, prefetch: int = 2):
    """Track a sequence with decode-ahead feeding.

    ``observers`` are per-observer image lists (objects with ``.read()`` or
    raw arrays); frame 0 initializes templates. Frames are decoded to
    float32 and the tracker casts them to its configuration's dtype on its
    device. Returns (state, outputs) like :meth:`BatchTracker.track_stream`.
    """
    feeder = FrameFeeder(observers, prefetch=prefetch)
    frames = iter(feeder)
    first = next(frames)
    return tracker.track_stream(generator, first, frames, dts)
