"""Photorealistic image synthesis from a DEM (Camera.project_dem backend).

The counterpart of :mod:`glimpse_tpu.render`: DEM cells carrying
value layers are projected into the camera and scatter-averaged per pixel,
with optional per-tile distance-adaptive rescaling (cells per pixel) and an
optional depth layer. Tiles fan out over a host thread pool; the per-tile
math is vectorized and the projection goes through the camera's tensor ops.
"""
from typing import Iterable, Union

import numpy as np

from . import config, helpers

Number = Union[int, float]


def project_dem(
    cam,
    dem,
    values: np.ndarray = None,
    mask: np.ndarray = None,
    tile_size: Iterable[int] = (256, 256),
    tile_overlap: Iterable[int] = (1, 1),
    scale: Number = 1,
    scale_limits: Iterable[Number] = (1, 1),
    parallel: Union[bool, int] = False,
    return_depth: bool = False,
) -> np.ndarray:
    """Render an image of `values` draped on `dem` as seen by `cam`.

    Returns (ny, nx, nbands) with NaN where no DEM cell projects; the depth
    layer (distance along the optical axis) is appended when requested.
    """
    has_values = values is not None
    if has_values:
        values = np.atleast_3d(values)
        if values.shape[0:2] != dem.shape:
            raise ValueError("values does not have the same 2-d shape as dem")
    elif not return_depth:
        raise ValueError("values cannot be missing if return_depth is False")
    if mask is None:
        mask = ~np.isnan(dem.array)
    if mask.shape != dem.shape:
        raise ValueError("mask does not have the same 2-d shape as dem")
    parallel = helpers._parse_parallel(parallel)
    tile_indices = dem.tile_indices(size=tile_size, overlap=tile_overlap)
    nbands = (values.shape[2] if has_values else 0) + int(return_depth)
    imgsz = cam.imgsz
    array = np.full((imgsz[1], imgsz[0], nbands), np.nan)

    def process(ij):
        tile_mask = mask[ij]
        if not np.count_nonzero(tile_mask):
            return None
        tile = dem[ij]
        tile_values = values[ij] if has_values else None
        # Rescale the tile so its cells are ~`scale` per image pixel.
        mean_xyz = (
            tile.xlim.mean(),
            tile.ylim.mean(),
            np.nanmean(tile.array[tile_mask]),
        )
        if np.isnan(mean_xyz[2]):
            return None
        _, mean_depth = cam._xyz_to_xy(np.atleast_2d(mean_xyz), return_depth=True)
        tile_scale = scale * np.abs(tile.d).mean() / (mean_depth[0] / cam.f.mean())
        tile_scale = min(max(tile_scale, min(scale_limits)), max(scale_limits))
        if tile_scale != 1:
            import scipy.ndimage

            tile.resize(tile_scale)
            tile_mask_r = scipy.ndimage.zoom(
                tile_mask, zoom=float(tile_scale), order=0
            )
            if has_values:
                tile_values = np.dstack(
                    [
                        scipy.ndimage.zoom(
                            tile_values[:, :, i], zoom=float(tile_scale), order=1
                        )
                        for i in range(tile_values.shape[2])
                    ]
                )
            tile_mask = tile_mask_r
        xyz = np.column_stack(
            (
                tile.X[tile_mask],
                tile.Y[tile_mask],
                tile.array[tile_mask],
            )
        )
        if return_depth:
            xy, depth = cam._xyz_to_xy(xyz, return_depth=True)
            uv = cam._xy_to_uv(xy)
        else:
            uv = cam.xyz_to_uv(xyz)
        is_in = cam.inframe(uv)
        if not np.count_nonzero(is_in):
            return None
        rc = uv[is_in, ::-1].astype(int)
        if has_values:
            cell_values = tile_values[tile_mask][is_in]
        if return_depth:
            depth_col = depth[is_in, None]
            cell_values = (
                np.column_stack((cell_values, depth_col))
                if has_values
                else depth_col
            )
        shape = (imgsz[1], imgsz[0])
        fidx, means = helpers.rasterize_points(
            rc[:, 0], rc[:, 1], cell_values, shape=shape
        )
        return np.unravel_index(fidx, shape), means

    def reduce(idx=None, cell_means=None):
        if idx is not None:
            array[idx] = cell_means
        return None

    with config.backend(np=parallel) as pool:
        pool.map(func=process, reduce=reduce, sequence=tile_indices)
    return array
