"""External camera model formats: MATLAB, OpenCV, Agisoft, PhotoModeler.

The counterpart of :mod:`glimpse_tpu.convert.cameras`: each format parses
its vendor files, implements its own distortion model (outgoing
``_xy_to_uv`` or incoming ``_uv_to_xy``), and converts to and from
:class:`glimpse_tpu_torch.Camera` exactly when the models are algebraically
equivalent, by a least-squares fit otherwise (through
:class:`glimpse_tpu_torch.convert.Converter`, whose exact Jacobian runs in
float64 on ``device``). The distortion models take NumPy arrays or float64
tensors alike, so the fit can differentiate them.
"""
import re
import warnings
import xml.etree.ElementTree
from pathlib import Path
from typing import Any, Dict, Iterable, List, Tuple, Union

import numpy as np
import torch

from ..camera import Camera
from .converter import Converter

Parameters = Dict[str, Union[bool, int, Iterable[int]]]
Optimize = Union[bool, Parameters]


def _columns(a, b):
    """Two coordinate columns (n,) side by side (n, 2), arrays or tensors."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.stack((a, b), dim=1)
    return np.column_stack((a, b))


def _over(a, b):
    """``a / b``, with ``b`` on ``a``'s device when ``a`` is a tensor: a CUDA
    division by a host number multiplies by its reciprocal, which rounds
    otherwise than the CPU's division, and the card's Jacobian would then
    part from the CPU's in the last bit."""
    if isinstance(a, torch.Tensor):
        b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return a / b


def _fourth(x):
    """``x ** 4``; on tensors as a square of squares, which rounds alike on
    every device (``pow`` on a card need not round as the CPU's does)."""
    if isinstance(x, torch.Tensor):
        return (x * x) * (x * x)
    return x ** 4


def _fit_cam(xcam, cam: Camera, optimize: Optimize, default: Parameters,
             uv, device="cuda", **kwargs: Any) -> Camera:
    """Refine a converted Camera against its source model by least squares."""
    params = default if optimize is True else optimize
    fitter = Converter(xcam=xcam, cam=cam, uv=uv, device=device)
    fitter.optimize_cam(params=params, **kwargs)
    return fitter.cam


def _fit_xcam(xcam, cam: Camera, optimize: Optimize, default: Parameters,
              uv, device="cuda", **kwargs: Any):
    """Refine a converted external camera against a Camera by least squares."""
    params = default if optimize is True else optimize
    fitter = Converter(xcam=xcam, cam=cam, uv=uv, device=device)
    fitter.optimize_xcam(params=params, **kwargs)
    return fitter.xcam


class Matlab:
    """Camera Calibration Toolbox for MATLAB (Bouguet) model.

    Principal point ``cc`` is in a frame where the center of the top-left
    pixel is (0, 0); ``kc`` = (k1, k2, p1, p2, k3); ``alpha_c`` is skew.
    """

    def __init__(self, imgsz, fc, cc=None, kc=(0, 0, 0, 0, 0), alpha_c: float = 0):
        params = {k: v for k, v in locals().items() if k != "self"}
        if params["cc"] is None:
            # Default principal point: center of the (0, 0)-at-top-left-pixel
            # frame.
            params["cc"] = tuple((np.asarray(imgsz, dtype=float) - 1) / 2)
        vars(self).update(params)

    @classmethod
    def from_report(cls, path: Union[str, Path], sigmas: bool = False) -> "Matlab":
        """Parse a Calib_Results.m report (means, or sigmas = error / 3)."""
        # Collect every scalar/vector MATLAB assignment in one generic pass,
        # then pick out the fields of interest.
        table: Dict[str, Tuple[float, ...]] = {}
        scale = 1 / 3 if sigmas else 1  # report errors are ~3 sigma
        pattern = r"^\s*(\w+) = (\[[^\]]*\]|[^;\[\]]+);"
        for name, body in re.findall(
            pattern, Path(path).read_text(), flags=re.MULTILINE
        ):
            body = body.strip().strip("[]")
            try:
                values = tuple(float(v) * scale for v in body.split(";"))
            except ValueError:
                continue
            table.setdefault(name, values)

        def field(name: str) -> Tuple[float, ...]:
            return table[f"{name}_error" if sigmas else name]

        if sigmas:
            imgsz = (0, 0)
        else:
            imgsz = int(table["nx"][0]), int(table["ny"][0])
        return cls(
            imgsz=imgsz,
            fc=field("fc"),
            cc=field("cc"),
            kc=field("kc"),
            alpha_c=field("alpha_c")[0],
        )

    @classmethod
    def _from_camera_initial(cls, cam: Camera) -> "Matlab":
        # MATLAB's cc frame puts (0, 0) at the center of the top-left pixel.
        center = np.asarray(cam.c) + (np.asarray(cam.imgsz) - 1) / 2
        return cls(
            imgsz=tuple(cam.imgsz),
            fc=tuple(cam.f),
            cc=tuple(center),
            kc=(cam.k[0], cam.k[1], cam.p[0], cam.p[1], cam.k[2]),
        )

    @classmethod
    def from_camera(cls, cam: Camera, optimize: Optimize = True, uv=1000,
                    device="cuda", **kwargs: Any) -> "Matlab":
        """Exact when cam.k[3:6] are zero, else fit ``kc``."""
        xcam = cls._from_camera_initial(cam)
        if not optimize or (cam.k[3:6] == 0).all():
            return xcam
        return _fit_xcam(xcam, cam, optimize, {"kc": True}, uv, device=device, **kwargs)

    def _xy_to_uv(self, xy: np.ndarray) -> np.ndarray:
        r2 = (xy ** 2).sum(1)
        dr = self.kc[0] * r2 + self.kc[1] * r2 ** 2 + self.kc[4] * r2 ** 3
        xty = xy[:, 0] * xy[:, 1]
        dtx = 2 * self.kc[2] * xty + self.kc[3] * (r2 + 2 * xy[:, 0] ** 2)
        dty = self.kc[2] * (r2 + 2 * xy[:, 1] ** 2) + 2 * self.kc[3] * xty
        dx = xy[:, 0] * (1 + dr) + dtx
        dy = xy[:, 1] * (1 + dr) + dty
        uv = _columns(
            self.fc[0] * (dx + self.alpha_c * dy) + self.cc[0],
            self.fc[1] * dy + self.cc[1],
        )
        # Shift to the frame where the top-left pixel corner is (0, 0).
        return uv + 0.5

    def _to_camera_initial(self) -> Camera:
        offset = np.asarray(self.cc) - (np.asarray(self.imgsz) - 1) / 2
        return Camera(
            imgsz=self.imgsz,
            f=self.fc,
            c=tuple(offset),
            k=(self.kc[0], self.kc[1], self.kc[4]),
            p=(self.kc[2], self.kc[3]),
        )

    def to_camera(self, optimize: Optimize = True, uv=1000, device="cuda", **kwargs: Any) -> Camera:
        """Exact when ``alpha_c`` is zero, else fit f/c/k/p."""
        cam = self._to_camera_initial()
        if not optimize or not self.alpha_c:
            return cam
        default = {"f": True, "c": True, "k": True, "p": True}
        return _fit_cam(self, cam, optimize, default, uv, device=device, **kwargs)


class OpenCV:
    """OpenCV frame camera model (rational radial + tangential + thin prism)."""

    _DIST_KEYS = ("k1", "k2", "p1", "p2", "k3", "k4", "k5", "k6",
                  "s1", "s2", "s3", "s4")

    def __init__(self, imgsz, fx, fy, cx=None, cy=None, k1=0, k2=0, k3=0, k4=0,
                 k5=0, k6=0, p1=0, p2=0, s1=0, s2=0, s3=0, s4=0):
        params = {k: v for k, v in locals().items() if k != "self"}
        # Principal point defaults to the image center.
        for axis, span in zip(("cx", "cy"), imgsz):
            if params[axis] is None:
                params[axis] = span / 2
        vars(self).update(params)

    @property
    def cameraMatrix(self) -> List[Tuple[float, ...]]:
        """OpenCV camera matrix [(fx 0 cx), (0 fy cy), (0 0 1)]."""
        return [(self.fx, 0.0, self.cx), (0.0, self.fy, self.cy), (0.0, 0.0, 1.0)]

    @property
    def distCoeffs(self) -> List[float]:
        """OpenCV distortion vector (k1 k2 p1 p2 k3 k4 k5 k6 s1 s2 s3 s4)."""
        return [getattr(self, key) for key in self._DIST_KEYS]

    @classmethod
    def from_arrays(cls, cameraMatrix, distCoeffs, imgsz) -> "OpenCV":
        """From a camera matrix and distortion coefficient vector."""
        kwargs = {
            "fx": cameraMatrix[0][0], "fy": cameraMatrix[1][1],
            "cx": cameraMatrix[0][2], "cy": cameraMatrix[1][2],
        }
        if len(distCoeffs) > len(cls._DIST_KEYS):
            warnings.warn(
                f"Coefficients past {cls._DIST_KEYS[-1]} are not supported "
                "and were ignored"
            )
            distCoeffs = distCoeffs[: len(cls._DIST_KEYS)]
        kwargs.update({cls._DIST_KEYS[i]: v for i, v in enumerate(distCoeffs)})
        return cls(imgsz=imgsz, **kwargs)

    @classmethod
    def from_xml(cls, path: Union[str, Path], imgsz) -> "OpenCV":
        """From an OpenCV XML calibration file."""
        tree = xml.etree.ElementTree.parse(path)
        matrix_el = tree.findall(".//camera_matrix/data")
        if not (matrix_el and matrix_el[0].text):
            raise ValueError("No camera matrix found")
        matrix = np.asarray(
            [float(x) for x in re.findall(r"([0-9\-\.e\+]+)", matrix_el[0].text)]
        ).reshape(3, 3)
        dist = []
        dist_el = tree.findall(".//distortion_coefficients/data")
        if dist_el and dist_el[0].text:
            dist = [float(x) for x in re.findall(r"([0-9\-\.e\+]+)", dist_el[0].text)]
        return cls.from_arrays(matrix, dist, imgsz=imgsz)

    @classmethod
    def _from_camera_initial(cls, cam: Camera) -> "OpenCV":
        return cls(
            imgsz=(cam.imgsz[0], cam.imgsz[1]),
            fx=cam.f[0], fy=cam.f[1],
            cx=cam.c[0] + cam.imgsz[0] / 2, cy=cam.c[1] + cam.imgsz[1] / 2,
            k1=cam.k[0], k2=cam.k[1], k3=cam.k[2],
            k4=cam.k[3], k5=cam.k[4], k6=cam.k[5],
            p1=cam.p[0], p2=cam.p[1],
        )

    @classmethod
    def from_camera(cls, cam: Camera) -> "OpenCV":
        """Always exact: the OpenCV model is a superset of Camera's."""
        return cls._from_camera_initial(cam)

    def _xy_to_uv(self, xy: np.ndarray) -> np.ndarray:
        r2 = (xy ** 2).sum(1)
        dr = (1 + self.k1 * r2 + self.k2 * r2 ** 2 + self.k3 * r2 ** 3) / (
            1 + self.k4 * r2 + self.k5 * r2 ** 2 + self.k6 * r2 ** 3
        )
        xty = xy[:, 0] * xy[:, 1]
        dtx = self.p2 * (r2 + 2 * xy[:, 0] ** 2) + 2 * self.p1 * xty
        dty = self.p1 * (r2 + 2 * xy[:, 1] ** 2) + 2 * self.p2 * xty
        dx = dr * xy[:, 0] + dtx + self.s1 * r2 + self.s2 * r2 ** 2
        dy = dr * xy[:, 1] + dty + self.s3 * r2 + self.s4 * r2 ** 2
        return _columns(self.fx * dx + self.cx, self.fy * dy + self.cy)

    def _to_camera_initial(self) -> Camera:
        return Camera(
            imgsz=self.imgsz,
            f=(self.fx, self.fy),
            c=(self.cx - self.imgsz[0] / 2, self.cy - self.imgsz[1] / 2),
            k=(self.k1, self.k2, self.k3, self.k4, self.k5, self.k6),
            p=(self.p1, self.p2),
        )

    def to_camera(self, optimize: Optimize = True, uv=1000, device="cuda", **kwargs: Any) -> Camera:
        """Exact when thin-prism coefficients are zero, else fit k/p."""
        cam = self._to_camera_initial()
        has_prism = any((self.s1, self.s2, self.s3, self.s4))
        if not optimize or not has_prism:
            return cam
        return _fit_cam(self, cam, optimize, {"k": True, "p": True}, uv, device=device, **kwargs)


class Agisoft:
    """Agisoft PhotoScan/Metashape/Lens frame camera model."""

    _XML_TAGS = ("width", "height", "f", "cx", "cy", "k1", "k2", "k3", "k4",
                 "p1", "p2", "b1", "b2")

    def __init__(self, imgsz, f, cx=0, cy=0, k1=0, k2=0, k3=0, k4=0, p1=0, p2=0,
                 b1=0, b2=0):
        vars(self).update(
            {k: v for k, v in locals().items() if k != "self"}
        )

    @classmethod
    def from_xml(cls, path: Union[str, Path]) -> "Agisoft":
        """From an Agisoft XML calibration file."""
        tree = xml.etree.ElementTree.parse(path)
        node = next(tree.iter("calibration"), None)
        if node is None:
            raise ValueError("No <calibration> element found")
        text = {child.tag: child.text for child in node}
        projection = text.pop("projection", "frame")
        if projection != "frame":
            raise ValueError(f"Unsupported camera model type: {projection}")
        fields = {
            tag: float(value)
            for tag, value in text.items()
            if value and tag in cls._XML_TAGS
        }
        size = int(fields.pop("width")), int(fields.pop("height"))
        return cls(imgsz=size, **fields)

    @classmethod
    def _from_camera_initial(cls, cam: Camera) -> "Agisoft":
        return cls(
            imgsz=(cam.imgsz[0], cam.imgsz[1]),
            f=cam.f[1],
            cx=cam.c[0], cy=cam.c[1],
            k1=cam.k[0], k2=cam.k[1], k3=cam.k[2],
            p1=cam.p[1], p2=cam.p[0],
            b1=cam.f[0] - cam.f[1],
        )

    @classmethod
    def from_camera(cls, cam: Camera, optimize: Optimize = True, uv=1000,
                    device="cuda", **kwargs: Any) -> "Agisoft":
        """Exact when cam.k[3:6] are zero, else fit k1-k3."""
        xcam = cls._from_camera_initial(cam)
        if not optimize or (cam.k[3:6] == 0).all():
            return xcam
        default = {"k1": True, "k2": True, "k3": True}
        return _fit_xcam(xcam, cam, optimize, default, uv, device=device, **kwargs)

    def _xy_to_uv(self, xy: np.ndarray) -> np.ndarray:
        r2 = (xy ** 2).sum(1)
        dr = (
            self.k1 * r2 + self.k2 * r2 ** 2 + self.k3 * r2 ** 3 + self.k4 * _fourth(r2)
        )
        xty = xy[:, 0] * xy[:, 1]
        dtx = self.p1 * (r2 + 2 * xy[:, 0] ** 2) + 2 * self.p2 * xty
        dty = self.p2 * (r2 + 2 * xy[:, 1] ** 2) + 2 * self.p1 * xty
        dx = xy[:, 0] * (1 + dr) + dtx
        dy = xy[:, 1] * (1 + dr) + dty
        return _columns(
            self.imgsz[0] * 0.5 + self.cx + dx * (self.f + self.b1) + dy * self.b2,
            self.imgsz[1] * 0.5 + self.cy + dy * self.f,
        )

    def _to_camera_initial(self) -> Camera:
        return Camera(
            imgsz=self.imgsz,
            f=(self.f + self.b1, self.f),
            c=(self.cx, self.cy),
            k=(self.k1, self.k2, self.k3),
            p=(self.p2, self.p1),
        )

    def to_camera(self, optimize: Optimize = True, uv=1000, device="cuda", **kwargs: Any) -> Camera:
        """Exact when ``k4`` and ``b2`` are zero, else fit affected params."""
        cam = self._to_camera_initial()
        if not optimize or not any((self.k4, self.b2)):
            return cam
        default: Parameters = {"k": True}
        if self.b2:
            default.update({"f": True, "c": True})
        return _fit_cam(self, cam, optimize, default, uv, device=device, **kwargs)


class PhotoModeler:
    """PhotoModeler camera model (incoming distortion, millimeter frame)."""

    def __init__(self, imgsz, focal, xp=0, yp=0, fw=0, fh=0, k1=0, k2=0, k3=0,
                 p1=0, p2=0):
        vars(self).update(
            {k: v for k, v in locals().items() if k != "self"}
        )

    @classmethod
    def from_report(cls, path: Union[str, Path], imgsz, sigmas: bool = False) -> "PhotoModeler":
        """Parse a PhotoModeler calibration project report."""
        labels = {
            "focal": "Focal Length", "xp": "Xp", "yp": "Yp",
            "fw": "Fw", "fh": "Fh",
            "k1": "K1", "k2": "K2", "k3": "K3", "p1": "P1", "p2": "P2",
        }
        txt = Path(path).read_text()
        if sigmas:
            pattern = r".*\s.*\s*Deviation: .*: ([0-9\-\+\.e]+)"
        else:
            pattern = r".*\s*Value: ([0-9\-\+\.e]+)"
        kwargs = {}
        for key, label in labels.items():
            found = re.findall(label + pattern, txt)
            kwargs[key] = float(found[0]) if found else 0.0
        return cls(imgsz=imgsz, **kwargs)

    @classmethod
    def _from_camera_initial(cls, cam: Camera) -> "PhotoModeler":
        if cam.sensorsz is None:
            raise ValueError("Camera sensor size (sensorsz) is required")
        return cls(
            imgsz=(cam.imgsz[0], cam.imgsz[1]),
            focal=(cam.fmm[0] + cam.fmm[1]) / 2,
            xp=cam.cmm[0] + cam.sensorsz[0] / 2,
            yp=cam.cmm[1] + cam.sensorsz[1] / 2,
            fw=cam.sensorsz[0],
            fh=cam.sensorsz[1],
        )

    @classmethod
    def from_camera(cls, cam: Camera, optimize: Optimize = True, uv=1000,
                    device="cuda", **kwargs: Any) -> "PhotoModeler":
        """Exact for ideal cameras with square focal lengths, else fit."""
        xcam = cls._from_camera_initial(cam)
        anisotropic = cam.fmm[0] != cam.fmm[1]
        distorted_k = bool(np.any(cam.k != 0))
        distorted_p = bool(np.any(cam.p != 0))
        if not optimize or not (anisotropic or distorted_k or distorted_p):
            return xcam
        default: Parameters = {}
        if anisotropic:
            default.update(
                {"focal": True, "xp": True, "yp": True, "fw": True, "fh": True}
            )
        if distorted_k:
            default.update({"k1": True, "k2": True, "k3": True})
        if distorted_p:
            default.update({"p1": True, "p2": True})
        return _fit_xcam(xcam, cam, optimize, default, uv, device=device, **kwargs)

    def _uv_to_xy(self, uv: np.ndarray) -> np.ndarray:
        """Incoming distortion: image coordinates to normalized camera frame."""
        x = _over(uv[:, 0] * self.fw, self.imgsz[0]) - self.xp
        y = -(_over(uv[:, 1] * self.fh, self.imgsz[1]) - self.yp)
        r2 = x * x + y * y
        dr = self.k1 * r2 + self.k2 * r2 ** 2 + self.k3 * r2 ** 3
        xty = x * y
        dtx = self.p1 * (r2 + 2 * x ** 2) + 2 * self.p2 * xty
        dty = self.p2 * (r2 + 2 * y ** 2) + 2 * self.p1 * xty
        x = x + x * dr + dtx
        y = -(y + y * dr + dty)
        return _over(_columns(x, y), self.focal)

    def _to_camera_initial(self) -> Camera:
        return Camera(
            imgsz=self.imgsz,
            sensorsz=(self.fw, self.fh),
            fmm=self.focal,
            cmm=(self.xp - self.fw / 2, self.yp - self.fh / 2),
        )

    def to_camera(self, optimize: Optimize = True, uv=1000, device="cuda", **kwargs: Any) -> Camera:
        """Exact when distortion-free, else fit k and/or p."""
        cam = self._to_camera_initial()
        has_radial = any((self.k1, self.k2, self.k3))
        has_tangential = any((self.p1, self.p2))
        if not optimize or not (has_radial or has_tangential):
            return cam
        default: Parameters = {}
        if has_radial:
            default["k"] = True
        if has_tangential:
            default["p"] = True
        return _fit_cam(self, cam, optimize, default, uv, device=device, **kwargs)
