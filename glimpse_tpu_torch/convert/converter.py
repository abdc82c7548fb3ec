"""Fit between external camera models and the port's camera model.

The counterpart of :mod:`glimpse_tpu.convert.converter`: residuals are
evaluated on a regular image-point grid, and either camera's selected
parameters are fit by least squares to minimize them. External cameras with
an *outgoing* distortion model implement ``_xy_to_uv``; those with an
*incoming* model implement ``_uv_to_xy``.

By default a fit runs the reference's algorithm: the residuals are the
host's float64 NumPy values and :func:`scipy.optimize.least_squares` takes
its own 2-point differences of them, with unit parameter scales. So the
default fit gives the reference's parameters bit for bit, also where the
residuals do not pin them (a port camera's k1-k6 against a model with fewer
radial terms; PhotoModeler's focal length, sensor size and principal point,
which share one scale).

``jac="exact"`` is an option: the Jacobian handed to scipy is exact, by
``torch.func.jacfwd`` over the same residual written on float64 tensors on
``device`` (through the camera's undistortion by the implicit function
theorem at its Oulu fixed point), and the trust region is scaled by the
Jacobian's columns (``x_scale="jac"``) unless the caller says otherwise.
"""
import copy
from typing import Any, Callable, Dict, Iterable, Union

import numpy as np
import scipy.optimize
import torch

from .. import optimize as optimize_module
from ..camera import Camera
from ..ops import projection

Parameters = Dict[str, Union[bool, int, Iterable[int]]]


class Converter:
    """Convert between an external camera and a port camera.

    Both cameras must share an image size; residuals are computed at ``uv``
    image points (or a generated ~n-point grid when ``uv`` is an int). The
    fits' Jacobians run on ``device``.
    """

    def __init__(self, xcam, cam: Camera, uv: Union[np.ndarray, int] = 1000, device="cuda") -> None:
        if any(np.asarray(xcam.imgsz) != cam.imgsz):
            raise ValueError("Cameras have different image sizes.")
        self.xcam = xcam
        self.cam = cam
        if isinstance(uv, int):
            uv = self._grid(uv)
        self.uv = np.atleast_2d(uv)
        self.device = torch.device(device)

    def _grid(self, n: int) -> np.ndarray:
        """Regular point grid with edge spacing half the point spacing."""
        imgsz = self.cam.imgsz
        d = np.sqrt(imgsz[0] * imgsz[1] / n)
        dx = imgsz[0] / round(imgsz[0] / d)
        dy = imgsz[1] / round(imgsz[1] / d)
        x = np.arange(0.5 * dx, imgsz[0], dx)
        y = np.arange(0.5 * dy, imgsz[1], dy)
        return np.reshape(np.meshgrid(x, y), (2, -1)).T

    def residuals(self) -> np.ndarray:
        """Image coordinate residuals cam - xcam at the test points.

        Incoming xcam models (``_uv_to_xy``): points leave xcam and enter
        cam. Outgoing models: points leave cam, then enter both cameras (the
        cam round trip cancels inversion error).
        """
        if hasattr(self.xcam, "_uv_to_xy"):
            predicted = self.cam._xy_to_uv(self.xcam._uv_to_xy(self.uv))
            return predicted - self.uv
        leave = self.cam._uv_to_xy(self.uv)
        into_cam, into_xcam = (
            c._xy_to_uv(leave) for c in (self.cam, self.xcam)
        )
        return into_cam - into_xcam

    def _const(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=torch.float64, device=self.device)

    def _residual_tensor(self, vector: torch.Tensor, xcam) -> torch.Tensor:
        """:meth:`residuals`, flat, on tensors: ``vector`` the camera's
        20-vector, ``xcam`` the external camera (its attributes numbers or
        tensors)."""
        uv = self._const(self.uv)
        intrinsics = (vector[projection.IMGSZ], vector[projection.F], vector[projection.C],
                      vector[projection.K], vector[projection.P])
        if hasattr(xcam, "_uv_to_xy"):
            return (projection.camera_to_image(xcam._uv_to_xy(uv), *intrinsics) - uv).reshape(-1)
        imgsz, f, c, k, p = intrinsics
        xy = (uv - (imgsz * 0.5 + c)) / f
        # The camera's Oulu fixed point, held; then one Newton step on
        # distort(leave) = xy with the distortion's 2x2 Jacobian held too
        # (inverted by its cofactors: elementwise, the same bits on any
        # device). The step moves the value by the fixed point's residual
        # only, and its derivative is the exact inverse's (implicit function
        # theorem), so no tangent runs through the 20 iterations.
        held_k, held_p = k.detach(), p.detach()
        fixed = projection.undistort_oulu(xy.detach(), held_k, held_p)
        J = torch.func.vmap(torch.func.jacfwd(lambda q: projection.distort(q, held_k, held_p)))(fixed)
        a, b, c_, d = J[:, 0, 0], J[:, 0, 1], J[:, 1, 0], J[:, 1, 1]
        r = projection.distort(fixed, k, p) - xy
        det = a * d - b * c_
        step = torch.stack(((d * r[:, 0] - b * r[:, 1]) / det, (a * r[:, 1] - c_ * r[:, 0]) / det), dim=1)
        leave = fixed - step
        return (projection.camera_to_image(leave, *intrinsics) - xcam._xy_to_uv(leave)).reshape(-1)

    def _jacobian(self, build: Callable[[torch.Tensor], torch.Tensor], x: np.ndarray) -> np.ndarray:
        """The exact Jacobian at ``x`` of ``build(x)``, the flat residual."""
        return torch.func.jacfwd(build)(self._const(x)).cpu().numpy()

    def optimize_cam(self, params: Parameters, jac: str = "2-point", **kwargs: Any) -> None:
        """Least-squares fit of selected cam parameters to xcam.

        ``jac`` goes to :func:`scipy.optimize.least_squares`; its default,
        scipy's own, gives the reference's parameters bit for bit.
        ``jac="exact"`` differentiates the residual on ``device`` instead,
        with ``x_scale="jac"`` unless ``kwargs`` set one. Where the residuals
        pin the parameters (Matlab's and Agisoft's distortion fit to a port
        camera) the exact fit gives the reference's within 6e-11 relative;
        where they do not, it reaches the reference's cost or a lower one at
        other parameters (a port camera's k1-k6 against fewer radial terms,
        up to 11 % apart; PhotoModeler's k1-k3, 0.3 %). With unit scales the
        exact PhotoModeler fit of a camera of ``fmm=(3100, 3200)`` walks along
        the common scale of focal length, sensor size and principal point and
        ends at a cost of 4.989e-12 px^2 against 1.046e-22 with column scales
        (the reference's 1.261e-22), hence ``x_scale="jac"``.
        """
        mask, _ = optimize_module.Cameras.parse_params(params)
        vector = self.cam._vector
        free = np.flatnonzero(mask)
        place = np.zeros((vector.size, free.size))
        place[free, np.arange(free.size)] = 1

        def objective(values: np.ndarray) -> np.ndarray:
            vector[mask] = values
            return self.residuals().ravel()

        if jac == "exact":
            scatter = self._const(place)

            def build(values: torch.Tensor) -> torch.Tensor:
                held = self._const(np.where(mask, 0.0, vector))
                return self._residual_tensor(held + scatter @ values, self.xcam)

            kwargs["jac"] = lambda values: self._jacobian(build, values)
            kwargs.setdefault("x_scale", "jac")
        else:
            kwargs["jac"] = jac
        result = scipy.optimize.least_squares(
            objective, x0=vector[mask].copy(), **kwargs
        )
        vector[mask] = result.x

    def _xcam_slots(self, params: Parameters) -> list:
        """Resolve a {attribute: selection} spec into (name, indices) slots."""
        slots = []
        for name, selection in params.items():
            if not selection:
                continue
            width = np.atleast_1d(getattr(self.xcam, name)).size
            if selection is True:
                picked = np.arange(width)
            else:
                picked = np.atleast_1d(np.arange(width)[selection])
            slots.append((name, picked))
        return slots

    def _write_xcam(self, slots: list, flat: np.ndarray) -> None:
        """Scatter a flat parameter vector back into xcam attributes."""
        cursor = 0
        for name, picked in slots:
            values = np.atleast_1d(getattr(self.xcam, name)).astype(float)
            values[picked] = flat[cursor : cursor + picked.size]
            cursor += picked.size
            setattr(self.xcam, name, tuple(values) if values.size > 1 else values[0])

    def _xcam_on_tensors(self, slots: list, flat: torch.Tensor):
        """A copy of xcam whose fit attributes are tensors that follow
        ``flat`` (for differentiation)."""
        xcam = copy.copy(self.xcam)
        cursor = 0
        for name, picked in slots:
            values = np.atleast_1d(getattr(self.xcam, name)).astype(float)
            place = np.zeros((values.size, picked.size))
            place[picked, np.arange(picked.size)] = 1
            held = np.where(np.isin(np.arange(values.size), picked), 0.0, values)
            value = self._const(held) + self._const(place) @ flat[cursor : cursor + picked.size]
            cursor += picked.size
            setattr(xcam, name, value if values.size > 1 else value[0])
        return xcam

    def optimize_xcam(self, params: Parameters, jac: str = "2-point", **kwargs: Any) -> None:
        """Least-squares fit of selected xcam attributes to cam (``jac`` as
        in :meth:`optimize_cam`)."""
        slots = self._xcam_slots(params)
        x0 = np.concatenate(
            [
                np.atleast_1d(getattr(self.xcam, name)).astype(float)[picked]
                for name, picked in slots
            ]
        )

        def fun(x: np.ndarray) -> np.ndarray:
            self._write_xcam(slots, x)
            return self.residuals().ravel()

        if jac == "exact":
            def build(flat: torch.Tensor) -> torch.Tensor:
                return self._residual_tensor(self._const(self.cam._vector), self._xcam_on_tensors(slots, flat))

            kwargs["jac"] = lambda x: self._jacobian(build, x)
            kwargs.setdefault("x_scale", "jac")
        else:
            kwargs["jac"] = jac
        fit = scipy.optimize.least_squares(fun=fun, x0=x0, **kwargs)
        self._write_xcam(slots, fit.x)

    def plot(self, **kwargs: Any):
        """Quiver plot of residuals (xcam -> cam)."""
        import matplotlib.pyplot as plt

        kwargs = {
            "scale": 1, "width": 5, "color": "red", "scale_units": "xy",
            "angles": "xy", "units": "xy", **kwargs,
        }
        duv = kwargs["scale"] * self.residuals()
        return plt.quiver(self.uv[:, 0], self.uv[:, 1], duv[:, 0], duv[:, 1], **kwargs)
