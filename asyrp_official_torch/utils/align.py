"""FFHQ-style face alignment — the port's copy of the JAX package's
`utils/align.py` (reference utils/align_utils.py:33-213), for
`--align_face`.

The geometry — eye/mouth anchored quad, shrink, pad with reflection +
gaussian blend, quad transform to (256, 256) — is pure numpy/PIL/scipy and
takes 68-point landmarks as INPUT, so any detector can drive it.
`run_alignment(path)` mirrors the reference entry point: fully automatic
with dlib installed (`dlib_detector`, imported lazily) and the shape
predictor file on disk; in dlib-less environments it raises with
instructions unless a landmarks array or a custom detector is supplied.
The port downloads nothing: the predictor file is the caller's to provide.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import PIL.Image
import scipy.ndimage

__all__ = ["align_face_from_landmarks", "run_alignment", "dlib_detector"]


def align_face_from_landmarks(
    img: PIL.Image.Image,
    lm: np.ndarray,
    *,
    output_size: int = 256,
    transform_size: int = 256,
    enable_padding: bool = True,
) -> PIL.Image.Image:
    """lm: [68, 2] landmark array (dlib 68-point convention)."""
    lm = np.asarray(lm, np.float64)
    lm_eye_left = lm[36:42]
    lm_eye_right = lm[42:48]
    lm_mouth_outer = lm[48:60]

    eye_left = np.mean(lm_eye_left, axis=0)
    eye_right = np.mean(lm_eye_right, axis=0)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (lm_mouth_outer[0] + lm_mouth_outer[6]) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    # oriented crop rectangle
    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
    qsize = np.hypot(*x) * 2

    # shrink
    shrink = int(np.floor(qsize / output_size * 0.5))
    if shrink > 1:
        rsize = (
            int(np.rint(float(img.size[0]) / shrink)),
            int(np.rint(float(img.size[1]) / shrink)),
        )
        img = img.resize(rsize, PIL.Image.LANCZOS)
        quad /= shrink
        qsize /= shrink

    # crop
    border = max(int(np.rint(qsize * 0.1)), 3)
    crop = (
        int(np.floor(min(quad[:, 0]))), int(np.floor(min(quad[:, 1]))),
        int(np.ceil(max(quad[:, 0]))), int(np.ceil(max(quad[:, 1]))),
    )
    crop = (
        max(crop[0] - border, 0), max(crop[1] - border, 0),
        min(crop[2] + border, img.size[0]), min(crop[3] + border, img.size[1]),
    )
    if crop[2] - crop[0] < img.size[0] or crop[3] - crop[1] < img.size[1]:
        img = img.crop(crop)
        quad -= crop[0:2]

    # pad
    pad = (
        int(np.floor(min(quad[:, 0]))), int(np.floor(min(quad[:, 1]))),
        int(np.ceil(max(quad[:, 0]))), int(np.ceil(max(quad[:, 1]))),
    )
    pad = (
        max(-pad[0] + border, 0), max(-pad[1] + border, 0),
        max(pad[2] - img.size[0] + border, 0), max(pad[3] - img.size[1] + border, 0),
    )
    if enable_padding and max(pad) > border - 4:
        pad = np.maximum(pad, int(np.rint(qsize * 0.3)))
        arr = np.pad(
            np.float32(img), ((pad[1], pad[3]), (pad[0], pad[2]), (0, 0)), "reflect"
        )
        h, w, _ = arr.shape
        yy, xx, _ = np.ogrid[:h, :w, :1]
        mask = np.maximum(
            1.0 - np.minimum(np.float32(xx) / pad[0], np.float32(w - 1 - xx) / pad[2]),
            1.0 - np.minimum(np.float32(yy) / pad[1], np.float32(h - 1 - yy) / pad[3]),
        )
        blur = qsize * 0.02
        arr += (scipy.ndimage.gaussian_filter(arr, [blur, blur, 0]) - arr) * np.clip(
            mask * 3.0 + 1.0, 0.0, 1.0
        )
        arr += (np.median(arr, axis=(0, 1)) - arr) * np.clip(mask, 0.0, 1.0)
        img = PIL.Image.fromarray(
            np.uint8(np.clip(np.rint(arr), 0, 255)), "RGB"
        )
        quad += pad[:2]

    # transform
    img = img.transform(
        (transform_size, transform_size), PIL.Image.QUAD,
        (quad + 0.5).flatten(), PIL.Image.BILINEAR,
    )
    if output_size < transform_size:
        img = img.resize((output_size, output_size), PIL.Image.LANCZOS)
    return img


def dlib_detector(predictor_path: Optional[str] = None) -> Callable:
    """Build the dlib 68-landmark detector the reference uses
    (utils/align_utils.py:33-42, get_landmark :44-60): frontal face
    detector → shape predictor → [68, 2] points of the FIRST face.

    predictor_path: shape_predictor_68_face_landmarks.dat; defaults to
    $ASYRP_TPU_SHAPE_PREDICTOR or pretrained/shape_predictor_68_face_landmarks.dat."""
    import dlib  # hard dep of this constructor only

    predictor_path = (
        predictor_path
        or os.environ.get("ASYRP_TPU_SHAPE_PREDICTOR")
        or os.path.join("pretrained", "shape_predictor_68_face_landmarks.dat")
    )
    if not os.path.exists(predictor_path):
        raise FileNotFoundError(
            f"shape predictor not found at {predictor_path!r}; pass "
            "predictor_path= or set ASYRP_TPU_SHAPE_PREDICTOR (the file is "
            "dlib.net/files/shape_predictor_68_face_landmarks.dat.bz2, unpacked)"
        )

    face_detector = dlib.get_frontal_face_detector()
    predictor = dlib.shape_predictor(predictor_path)

    def detect(img: PIL.Image.Image) -> np.ndarray:
        arr = np.asarray(img.convert("RGB"))
        dets = face_detector(arr, 1)
        if not dets:
            raise ValueError("no face detected")
        shape = predictor(arr, dets[0])
        return np.asarray(
            [(shape.part(i).x, shape.part(i).y) for i in range(68)], np.float64
        )

    return detect


def run_alignment(
    image_path: str,
    *,
    landmarks: Optional[np.ndarray] = None,
    detector: Optional[Callable] = None,
    predictor_path: Optional[str] = None,
    output_size: int = 256,
) -> PIL.Image.Image:
    """Reference entry point (utils/align_utils.py:33): fully automatic with
    dlib installed (landmarks detected via `dlib_detector`), or driven by an
    explicit `landmarks` array / `detector(PIL.Image) -> [68, 2]` callable
    in dlib-less environments."""
    img = PIL.Image.open(image_path).convert("RGB")
    if landmarks is None:
        if detector is None:
            try:
                import dlib  # noqa: F401
            except ImportError as e:
                raise ImportError(
                    "face alignment needs 68-point landmarks: pass "
                    "`landmarks=`, a `detector=` callable, or install dlib "
                    "with the shape_predictor_68_face_landmarks model"
                ) from e
            detector = dlib_detector(predictor_path)
        landmarks = detector(img)
    return align_face_from_landmarks(img, landmarks, output_size=output_size)
