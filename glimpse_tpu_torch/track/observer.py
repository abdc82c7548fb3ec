"""A time sequence of images observed from one camera position.

The counterpart of :class:`glimpse_tpu.track.Observer`: datetime-indexed
image access, tile extraction/snap/shift/sampling, sequence subsetting and
splitting. Tile interpolation goes through the exact cubic B-spline ops in
:mod:`glimpse_tpu_torch.ops.sampling` instead of scipy splines.
"""
import datetime
from typing import Any, Iterable, List, Union

import numpy as np

from .. import helpers
from ..image import Image
from ..ops import sampling as sampling_ops
from ..raster import Grid, Raster


class Observer:
    """Images from a fixed viewpoint, strictly increasing in time.

    Attributes:
        images: Photographic (:class:`Image`) or geographic (:class:`Raster`)
            images.
        datetimes: Capture times.
        sigma: Expected pixel-value noise between images (used in the
            tracker's likelihood).
        cache: Whether to cache image data on read.
    """

    def __init__(
        self,
        images: Iterable[Union[Image, Raster]],
        sigma: float = 0.3,
        cache: bool = True,
    ) -> None:
        self.images = list(images)
        if len(self.images) < 2:
            raise ValueError("Images are not two or greater")
        times: List[datetime.datetime] = []
        for i, img in enumerate(self.images):
            stamp = img.datetime
            if stamp is None:
                raise ValueError(f"Image {i} is missing datetime")
            if times and stamp <= times[-1]:
                raise ValueError("Image datetimes are not strictly increasing")
            times.append(stamp)
        self.datetimes = np.array(times)
        self.sigma = sigma
        self.cache = cache

    def index(
        self,
        value: Union[Image, Raster, datetime.datetime],
        maxdt: datetime.timedelta = datetime.timedelta(0),
    ) -> int:
        """Index of an image, by identity or nearest datetime within maxdt."""
        if not isinstance(value, datetime.datetime):
            return self.images.index(value)
        gaps = np.abs(self.datetimes - value)
        best = int(gaps.argmin())
        if maxdt is not None:
            tolerance = abs(maxdt)
            if gaps[best] > tolerance:
                raise ValueError(
                    f"Nearest image out of range by {gaps[best] - tolerance}"
                )
        return best

    def xyz_to_uv(self, xyz: np.ndarray, img: int) -> np.ndarray:
        """Project world coordinates into an image of the sequence."""
        return self.images[img].xyz_to_uv(xyz)

    def tile_box(self, uv: Iterable[float], size: Iterable[int], img: int) -> np.ndarray:
        """Integer pixel-edge box of the given size centered near ``uv``."""
        grid = Grid(self.images[img].size)
        return grid.snap_box(uv, size, centers=False, edges=True).astype(int)

    def extract_tile(self, box: Iterable[int], img: int) -> np.ndarray:
        """Read the image region bounded by ``box`` (left, top, right, bottom)."""
        return self.images[img].read(box=box, cache=self.cache)

    def shift_tile(self, tile: np.ndarray, duv: Iterable[float], **kwargs: Any) -> np.ndarray:
        """Shift a tile by a subpixel offset (|duv| <= 0.5) via spline resampling."""
        if any(np.abs(duv) > 0.5):
            raise ValueError("Shift larger than 0.5 pixels")
        order = _interp_order(kwargs)
        tile3 = np.atleast_3d(np.asarray(tile, dtype=float))
        H, W = tile3.shape[0:2]
        rows = np.arange(H, dtype=float) + duv[1]
        cols = np.arange(W, dtype=float) + duv[0]
        R, C = np.meshgrid(rows, cols, indexing="ij")
        out = np.empty_like(tile3)
        for i in range(tile3.shape[2]):
            out[:, :, i] = sampling_ops.sample_grid_host(
                tile3[:, :, i], R, C, order=order
            )
        return out.squeeze(axis=2) if out.shape[2] == 1 else out

    def sample_tile(
        self,
        uv,
        tile: np.ndarray,
        box: Iterable[float],
        grid: bool = False,
        **kwargs: Any,
    ) -> np.ndarray:
        """Sample a tile at image coordinates (points or grid vectors).

        ``box`` gives the tile's boundaries in image coordinates; sampling
        uses the exact interpolating cubic B-spline (order from ``kx``/``ky``).
        """
        if not np.all(helpers.in_box(uv, box) if not grid else True):
            raise ValueError("Some sampling points are outside box")
        order = _interp_order(kwargs)
        du = (box[2] - box[0]) / tile.shape[1]
        dv = (box[3] - box[1]) / tile.shape[0]
        if grid:
            cols = (np.asarray(uv[0], dtype=float) - box[0]) / du - 0.5
            rows = (np.asarray(uv[1], dtype=float) - box[1]) / dv - 0.5
            R, C = np.meshgrid(rows, cols, indexing="ij")
            return sampling_ops.sample_grid_host(
                np.asarray(tile, dtype=float), R, C, order=order
            )
        uv = np.asarray(uv, dtype=float)
        cols = (uv[:, 0] - box[0]) / du - 0.5
        rows = (uv[:, 1] - box[1]) / dv - 0.5
        return sampling_ops.sample_grid_host(
            np.asarray(tile, dtype=float), rows, cols, order=order
        )

    def cache_images(self, index=slice(None)) -> None:
        """Read and cache image data for the given indices."""
        for img in np.asarray(self.images, dtype=object)[index]:
            img.read(cache=True)

    def clear_images(self, index=slice(None)) -> None:
        """Drop cached image data for the given indices."""
        for img in np.asarray(self.images, dtype=object)[index]:
            img.array = None

    def subset(self, **kwargs: Any) -> "Observer":
        """New Observer with images selected by :func:`helpers.select_datetimes`."""
        mask = helpers.select_datetimes(self.datetimes, **kwargs)
        images = [img for img, m in zip(self.images, mask) if m]
        return self.__class__(images, sigma=self.sigma, cache=self.cache)

    def split(
        self, n: Union[int, Iterable[datetime.datetime]], overlap: int = 1
    ) -> List["Observer"]:
        """Split into several Observers, overlapping by ``overlap`` images.

        The sequence-parallel decomposition: chunks are processed
        independently and their tracks fused (``Tracks.from_multiple``).
        """
        first, last = self.datetimes[0], self.datetimes[-1]
        if np.iterable(n):
            cuts = np.unique(np.hstack((n, [first, last])))
        else:
            cuts = helpers.datetime_range(first, last, (last - first) / n)
        chunks = []
        begin = cuts[0]
        for stop in cuts[1:]:
            piece = self.subset(start=begin, end=stop)
            chunks.append(piece)
            if overlap:
                back = min(overlap, len(piece.datetimes))
                begin = piece.datetimes[-back]
            else:
                begin = piece.datetimes[-1] + datetime.timedelta(microseconds=1)
        return chunks

    # ---- Plotting ---- #

    def plot_tile(self, tile: np.ndarray, box=None, axes=None, **kwargs: Any):
        """Plot a tile at its image-coordinate extent."""
        import matplotlib.pyplot

        if box is None:
            box = (0, 0, tile.shape[1], tile.shape[0])
        extent = (box[0], box[2], box[3], box[1])
        if axes is None:
            axes = matplotlib.pyplot.gca()
        return axes.imshow(tile, origin="upper", extent=extent, **kwargs)

    def plot_box(self, box, axes=None, **kwargs: Any):
        """Plot a bounding box."""
        import matplotlib.patches
        import matplotlib.pyplot

        left, top, right, bottom = box[0], box[1], box[2], box[3]
        rect = matplotlib.patches.Rectangle(
            (left, top), right - left, bottom - top, **kwargs
        )
        target = axes if axes is not None else matplotlib.pyplot.gca()
        return target.add_patch(rect)

    def animate(
        self,
        uv: Iterable[float] = None,
        frames: Iterable[int] = None,
        size: Iterable[int] = (100, 100),
        interval: float = 200,
        subplots: dict = {},
        animation: dict = {},
    ):
        """Animate tiles around a fixed target point (aligned vs raw panels)."""
        import matplotlib.animation
        import matplotlib.pyplot

        if uv is None:
            uv = self.images[0].size / 2
        if frames is None:
            frames = np.arange(len(self.images))
        anchor_xyz = self.images[frames[0]].uv_to_xyz(np.atleast_2d(uv))
        half = np.multiply(size, 0.5)
        fig, (ax_follow, ax_fixed) = matplotlib.pyplot.subplots(ncols=2, **subplots)
        box0 = self.tile_box(uv, size=size, img=0)
        tile0 = self.extract_tile(img=frames[0], box=box0)
        panels = [
            self.plot_tile(tile=tile0, box=box0, axes=a) for a in (ax_follow, ax_fixed)
        ]
        markers = [
            a.plot(uv[0], uv[1], marker=".", color="red")[0]
            for a in (ax_follow, ax_fixed)
        ]
        caption = ax_follow.text(
            0.5, 0.95, "", color="white", horizontalalignment="center",
            transform=ax_follow.transAxes,
        )
        ax_fixed.set_xlim(uv[0] - half[0], uv[0] + half[0])
        ax_fixed.set_ylim(uv[1] + half[1], uv[1] - half[1])

        def update(i: int) -> list:
            puv = self.images[i].xyz_to_uv(anchor_xyz)[0]
            box = self._clipped_pixel_box(i, puv, half)
            if box is None:
                tile = np.full((size[1], size[0], 3), 255, dtype=np.uint8)
                box = np.concatenate([puv - half, puv + half])
            else:
                tile = self.extract_tile(img=i, box=box.astype(int))
            for panel, marker in zip(panels, markers):
                panel.set_array(tile)
                panel.set_extent((box[0], box[2], box[3], box[1]))
                marker.set_xdata([puv[0]])
                marker.set_ydata([puv[1]])
            ax_follow.set_xlim(puv[0] - half[0], puv[0] + half[0])
            ax_follow.set_ylim(puv[1] + half[1], puv[1] - half[1])
            caption.set_text(f"{i} : {self._frame_label(i)}")
            return panels + markers + [caption]

        return matplotlib.animation.FuncAnimation(
            fig, update, frames=frames, interval=interval, blit=True, **animation
        )

    def _clipped_pixel_box(self, img: int, center, half) -> "np.ndarray":
        """Pixel-snapped box around ``center``, clipped to the frame.

        Returns None when the requested box lies entirely outside the image.
        """
        want = np.concatenate([center - half, center + half])
        visible = self.images[img].inbounds(helpers.box_to_polygon(want))
        if not visible.any():
            return None
        if not visible.all():
            frame = np.concatenate(([0, 0], self.images[img].size))
            want = helpers.intersect_boxes((want, frame))
        grid = Grid(self.images[img].size)
        return grid.snap_xy(
            helpers.unravel_box(want), centers=False, edges=True
        ).ravel()

    def _frame_label(self, img: int) -> str:
        path = getattr(self.images[img], "path", None)
        return helpers.strip_path(path) if path else str(self.datetimes[img])

    def track(
        self,
        xyz: Iterable[float],
        frames: Iterable[int] = None,
        size: Iterable[int] = (100, 100),
        interval: float = 200,
        subplots: dict = {},
        animation: dict = {},
    ):
        """Animate tiles following a moving world point."""
        import matplotlib.animation
        import matplotlib.pyplot

        xyz = np.asarray(xyz)
        if frames is None:
            frames = np.arange(len(xyz))
        fig, ax = matplotlib.pyplot.subplots(ncols=2, **subplots)
        track_uv = self.images[frames[0]].xyz_to_uv(xyz[0:1])
        uv = track_uv[-1]
        box = self.tile_box(uv, size=size, img=0)
        tile = self.extract_tile(img=frames[0], box=box)
        im = [self.plot_tile(tile=tile, box=box, axes=axes, zorder=1) for axes in ax]
        track_line = ax[1].plot(
            track_uv[:, 0], track_uv[:, 1], "y.-", alpha=0.5, zorder=2
        )[0]
        pt = [
            axis.plot(uv[0], uv[1], marker=".", color="red", zorder=3)[0]
            for axis in ax
        ]
        txt = ax[1].text(
            0.5, 0.95, "", color="white", horizontalalignment="center", zorder=4,
            transform=ax[1].transAxes,
        )

        def update(i: int) -> list:
            j = np.where(np.asarray(frames) == i)[0][0]
            track_uv = self.images[i].xyz_to_uv(xyz[: j + 1])
            uv = track_uv[-1]
            box = self.tile_box(uv, size=size, img=i)
            tile = self.extract_tile(img=i, box=box)
            im[1].set_array(tile)
            im[1].set_extent((box[0], box[2], box[3], box[1]))
            track_line.set_xdata(track_uv[:, 0])
            track_line.set_ydata(track_uv[:, 1])
            pt[1].set_xdata([uv[0]])
            pt[1].set_ydata([uv[1]])
            txt.set_text(f"{i} : {self._frame_label(i)}")
            return im + [track_line] + pt + [txt]

        return matplotlib.animation.FuncAnimation(
            fig, update, frames=frames, interval=interval, blit=True, **animation
        )


def _interp_order(kwargs: dict) -> int:
    """Map RectBivariateSpline-style kx/ky kwargs to an interpolation order."""
    kx = kwargs.get("kx", 3)
    ky = kwargs.get("ky", 3)
    if kx != ky:
        raise ValueError("Anisotropic spline orders (kx != ky) are not supported")
    return int(kx)
