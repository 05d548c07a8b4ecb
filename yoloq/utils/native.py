"""ctypes bindings for the native host runtime (native/libyoloq_host.so).

Builds the library with make on first use when a C++ toolchain is
available (rebuilding it when its sources changed); every entry point has a numpy fallback (the implementations in
eval/detect.py and data/image.py), so the framework works without the native
library — it is a host-CPU speedup for serving/eval, mirroring where the
reference spends host time (src/box.c, src/image.c).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libyoloq_host.so"))

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_failed = False


def _f32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def load_library(build: bool = True) -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            if build:
                # make rebuilds the library when a committed source is newer
                # than it and is a no-op otherwise
                subprocess.run(
                    ["make", "-C", os.path.abspath(_NATIVE_DIR)],
                    check=True, capture_output=True, timeout=120,
                )
            lib = ctypes.CDLL(_LIB_PATH)
        except (OSError, subprocess.SubprocessError):
            _lib_failed = True
            return None
        F = ctypes.POINTER(ctypes.c_float)
        lib.yq_nms_obj.restype = ctypes.c_int
        lib.yq_nms_obj.argtypes = [F, F, F, ctypes.c_int, ctypes.c_int, ctypes.c_float]
        lib.yq_nms_sort.restype = None
        lib.yq_nms_sort.argtypes = [F, F, ctypes.c_int, ctypes.c_int, ctypes.c_float]
        lib.yq_match_truths.restype = ctypes.c_int
        lib.yq_match_truths.argtypes = [
            F, F, ctypes.c_int, F, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, F,
        ]
        lib.yq_resize_bilinear.restype = None
        lib.yq_resize_bilinear.argtypes = [
            F, ctypes.c_int, ctypes.c_int, F, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.yq_letterbox.restype = None
        lib.yq_letterbox.argtypes = [
            F, ctypes.c_int, ctypes.c_int, F, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.yq_version.restype = ctypes.c_int
        # image decode + augmentation entry points only exist when the
        # library was built with libjpeg/libpng (native/Makefile HAVE_IMG)
        I = ctypes.POINTER(ctypes.c_int)
        try:
            lib.yq_image_size.restype = ctypes.c_int
            lib.yq_image_size.argtypes = [ctypes.c_char_p, I, I]
            lib.yq_decode_image.restype = ctypes.c_int
            lib.yq_decode_image.argtypes = [
                ctypes.c_char_p, F, ctypes.c_int, ctypes.c_int,
            ]
            lib.yq_augment_place.restype = None
            lib.yq_augment_place.argtypes = [
                F, ctypes.c_int, ctypes.c_int, F, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ]
            lib._has_image = True
        except AttributeError:
            lib._has_image = False
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def nms_obj(boxes: np.ndarray, obj: np.ndarray, cls: np.ndarray, thresh: float):
    """Native do_nms_obj; falls back to eval.detect.nms_obj.

    NOTE the native path zeroes in a stable objectness-sorted ORDER but keeps
    the input row order, while the numpy fallback returns sorted arrays; both
    satisfy the harness contract (suppressed rows kept with obj=0).
    """
    lib = load_library()
    if lib is None:
        from yoloq.eval.detect import nms_obj as np_nms

        return np_nms(boxes, obj, cls, thresh)
    b, o, c = _f32(boxes), _f32(obj.copy()), _f32(cls.copy())
    lib.yq_nms_obj(_ptr(b), _ptr(o), _ptr(c), len(o), c.shape[1], thresh)
    return b, o, c


def nms_sort(boxes: np.ndarray, probs: np.ndarray, thresh: float) -> np.ndarray:
    lib = load_library()
    if lib is None:
        from yoloq.eval.detect import nms_sort_per_class

        return nms_sort_per_class(boxes, probs, thresh)
    b, p = _f32(boxes), _f32(probs.copy())
    lib.yq_nms_sort(_ptr(b), _ptr(p), len(b), p.shape[1], thresh)
    return p


def match_truths(
    det_boxes: np.ndarray, det_obj: np.ndarray, truth_boxes: np.ndarray,
    thresh: float, iou_thresh: float,
) -> tuple[int, float]:
    """(TP count, sum of best IoUs) for the F1 harness inner loop."""
    lib = load_library()
    db, do, tb = _f32(det_boxes), _f32(det_obj), _f32(truth_boxes)
    if lib is None:
        from yoloq.eval.detect import box_iou

        tp, acc = 0, 0.0
        for t in tb:
            live = do > thresh
            best = float(np.max(box_iou(db[live], t))) if live.any() else 0.0
            acc += best
            if best > iou_thresh:
                tp += 1
        return tp, acc
    acc = np.zeros(1, np.float32)
    tp = lib.yq_match_truths(
        _ptr(db), _ptr(do), len(do), _ptr(tb), len(tb), thresh, iou_thresh, _ptr(acc)
    )
    return int(tp), float(acc[0])


def decode_image(path: str) -> np.ndarray | None:
    """libjpeg/libpng decode to float32 HWC RGB in [0,1] (the reference's
    stb-based load_image, src/image.c:1270-1316).  None -> caller falls back
    to PIL (unsupported format, or library built without image support)."""
    lib = load_library()
    if lib is None or not lib._has_image:
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.yq_image_size(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    dst = np.empty((h.value, w.value, 3), np.float32)
    if lib.yq_decode_image(path.encode(), _ptr(dst), h.value, w.value) != 0:
        return None
    return dst


def augment_place(
    im: np.ndarray, out_w: int, out_h: int, nw: int, nh: int, dx: int, dy: int,
    dhue: float, dsat: float, dexp: float, flip: bool,
) -> np.ndarray:
    """Fused resize + canvas placement + HSV distort + flip for one training
    sample (load_data_detection per-pixel chain, src/data.c:1036-1088).
    Random parameters are drawn by the caller; the numpy fallback in
    data/voc.py is the golden reference the native kernel is tested against."""
    lib = load_library()
    if lib is None or not lib._has_image:
        from yoloq.data.voc import place_distort_flip_numpy

        return place_distort_flip_numpy(
            im, out_w, out_h, nw, nh, dx, dy, dhue, dsat, dexp, flip
        )
    src = _f32(im)
    dst = np.empty((out_h, out_w, 3), np.float32)
    lib.yq_augment_place(
        _ptr(src), im.shape[0], im.shape[1], _ptr(dst), out_h, out_w,
        nw, nh, dx, dy, dhue, dsat, dexp, int(flip),
    )
    return dst


def letterbox(im: np.ndarray, net_w: int, net_h: int) -> np.ndarray:
    lib = load_library()
    if lib is None:
        from yoloq.data.image import letterbox as np_letterbox

        return np_letterbox(im, net_w, net_h)
    src = _f32(im)
    dst = np.empty((net_h, net_w, im.shape[2]), np.float32)
    lib.yq_letterbox(
        _ptr(src), im.shape[0], im.shape[1], _ptr(dst), net_h, net_w, im.shape[2]
    )
    return dst
