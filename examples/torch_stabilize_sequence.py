"""Sequence stabilization on the PyTorch port: view directions from image files.

The recipe of ``examples/stabilize_sequence.py`` on ``glimpse_tpu_torch``: a
time-lapse camera wobbles between frames; keypoint matches between image
pairs and an anchor image pin down every frame's view direction. Each frame
is the bundled photograph reprojected through a camera rotated by a known
jitter and written as a JPEG, so the recovered view directions have ground
truth. Keypoints are detected and matched on the device (no OpenCV), cached
as pickles, refined by correlation, and the stabilized frames are written
as GeoTIFFs by ``optimize.project_images``.

Run: python examples/torch_stabilize_sequence.py [--device cpu]
(the card by default; about 20 s on a CPU)
"""
import argparse
import datetime
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from glimpse_tpu_torch import Image, optimize
from glimpse_tpu_torch.io import geotiff

PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "assets", "AK10b_20141013_020336.JPG",
)


def main(device: str = "cuda") -> np.ndarray:
    import PIL.Image

    true_jitter = [(0.0, 0.0, 0.0), (0.4, -0.3, 0.2), (-0.5, 0.2, -0.3)]
    cam_kwargs = {"imgsz": (400, 268), "fmm": 20, "sensorsz": (23.6, 15.8)}
    anchor = Image(PATH, cam=cam_kwargs)

    with tempfile.TemporaryDirectory(prefix="stabilize_") as tmpdir:
        return stabilize(anchor, cam_kwargs, true_jitter, tmpdir, device)


def stabilize(anchor, cam_kwargs, true_jitter, tmpdir: str, device: str) -> np.ndarray:
    import PIL.Image

    t0 = datetime.datetime(2020, 1, 1)
    day = datetime.timedelta(days=1)
    images = []
    for i, jitter in enumerate(true_jitter):
        cam = anchor.cam.copy()
        cam.viewdir = jitter
        frame = np.nan_to_num(anchor.project(cam)).astype(np.uint8)
        path = os.path.join(tmpdir, f"frame_{i}.jpg")
        PIL.Image.fromarray(frame).save(path, quality=95)
        img = Image(path, cam=cam_kwargs, datetime=t0 + i * day)
        img.cam.viewdir = (0.0, 0.0, 0.0)  # wrong guess: unstabilized
        images.append(img)

    class SequenceObserver:
        def __init__(self, images):
            self.images = images

    model = optimize.ObserverCameras(SequenceObserver(images), anchors=[0], device=device)
    model.build_keypoints(detector="device", path=os.path.join(tmpdir, "keypoints"), nfeatures=1024)
    model.build_matches(maxdt=datetime.timedelta(days=5), matcher="device", max_ratio=0.8, max_distance=40.0,
                        refine=True, path=os.path.join(tmpdir, "matches"))
    result = model.fit()
    fitted = result.x.reshape(-1, 3)

    print(f"stabilization: {len(images)} frames, "
          f"{sum(m.size for m in model.matches.data)} matched keypoint pairs")
    for i, (truth, got) in enumerate(zip(true_jitter, fitted)):
        err = np.abs(np.asarray(got) - np.asarray(truth))
        print(f"  frame {i}: true viewdir {truth} -> recovered "
              f"({got[0]:+.3f}, {got[1]:+.3f}, {got[2]:+.3f}), "
              f"max error {err.max():.4f} deg")
    assert np.abs(fitted - np.asarray(true_jitter)).max() < 0.05, "stabilization off"
    print("stabilization: all frames recovered within 0.05 deg")

    model.set_cameras(fitted)
    outputs = [os.path.join(tmpdir, "stabilized", f"frame_{i}.tif") for i in range(len(images))]
    optimize.project_images(anchor.cam.copy(), images, outputs, device=device)
    stabilized = [geotiff.read(p).astype(float) for p in outputs]
    print("stabilized frames: mean |frame - anchor| = "
          + ", ".join(f"{np.mean(np.abs(a - stabilized[0])):.2f}" for a in stabilized[1:]) + " DN")
    return fitted


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    main(parser.parse_args().device)
