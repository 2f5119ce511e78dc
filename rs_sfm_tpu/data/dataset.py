"""Reference dataset-contract I/O.

Reads and writes the exact on-disk layout the reference consumes
(setupCameraSynthetic, src/main.cc:613-672; setupCameraReal,
src/main.cc:675-690; sweep GT files, src/main.cc:210-257):

  images/{1,2}_rs.png                      RS frames
  images/{1,2}_initial_gs.png              GS reference at scanline-0 pose
  images/{1,2}_initial_depth.png           normalized depth visualization
  images/{1,2}_rs_t.csv                    H x 3 per-scanline translations
  images/{1,2}_rs_r.csv                    H x 9 per-scanline rotations
                                           (row-major, take_sequence.m:28-33)
  images/{1,2}_rs_unproject_{x,y,z}.csv    H x W world-coordinate maps
  images/{1,2}_initial_gs_unproject_{x,y,z}.csv
  images/A.csv                             3 x 3 intrinsics
  v.csv w.csv gamma.csv k.csv              sweep ground truth (task dir)

Divergence (documented): w.csv is stored in *radians* (the MATLAB generator
writes degrees and converts internally, calculate_camera_trajectory.m:6 —
an inconsistency its own error metric then ignores).

Parsing of the large H x W CSVs goes through the native C++ reader when
built (rs_sfm_tpu.data.io_native), with a numpy fallback.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

from rs_sfm_tpu.data.png import read_png, write_png
from rs_sfm_tpu.geom.camera import Intrinsics


def _imread(path):
    return read_png(path)


def _imwrite(path, array_uint8):
    write_png(path, array_uint8)


def _read_csv_matrix(path) -> np.ndarray:
    try:
        from rs_sfm_tpu.data import io_native

        if io_native.available():
            return io_native.read_csv_matrix(path)
    except Exception:
        pass
    return np.loadtxt(path, delimiter=",", ndmin=2)


def _write_csv_matrix(path, mat) -> None:
    np.savetxt(path, np.asarray(mat), delimiter=",", fmt="%.10g")


class FrameData(NamedTuple):
    rs_image: np.ndarray            # (H, W, 3) uint8
    gs_image: Optional[np.ndarray]
    depth_image: Optional[np.ndarray]   # (H, W) uint8 normalized viz
    poses_r: Optional[np.ndarray]   # (H, 3, 3)
    poses_t: Optional[np.ndarray]   # (H, 3)
    rs_unproject: Optional[np.ndarray]  # (H, W, 3)
    gs_unproject: Optional[np.ndarray]


class PairData(NamedTuple):
    frame1: FrameData
    frame2: FrameData
    intrinsics: Intrinsics
    gamma: Optional[float] = None
    k: Optional[float] = None
    v: Optional[np.ndarray] = None
    w: Optional[np.ndarray] = None


def _to_uint8(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)


def _depth_png(depth) -> np.ndarray:
    """MATLAB-style normalized depth image (take_sequence.m:42-46)."""
    d = np.asarray(depth, dtype=np.float64)
    lo, hi = d.min(), d.max()
    norm = (d - lo) / (hi - lo) if hi > lo else np.zeros_like(d)
    return np.clip(np.round(norm * 255.0), 0, 255).astype(np.uint8)


def save_synthetic_pair(pair, task_dir: str) -> str:
    """Write a rendered SyntheticPair in the reference's sweep-task layout.

    Creates `<task_dir>/images/...` plus GT CSVs in `<task_dir>/`.
    Returns the images/ prefix (the `data_prefix` the loaders expect).
    """
    img_dir = os.path.join(task_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    prefix = os.path.join(img_dir, "")

    for num, fr in (("1", pair.frame1), ("2", pair.frame2)):
        _imwrite(prefix + f"{num}_rs.png", _to_uint8(fr.rs_image))
        _imwrite(prefix + f"{num}_initial_gs.png", _to_uint8(fr.gs_image))
        _imwrite(prefix + f"{num}_initial_depth.png", _depth_png(fr.gs_depth))
        _imwrite(prefix + f"{num}_rs_depth.png", _depth_png(fr.rs_depth))
        _write_csv_matrix(prefix + f"{num}_rs_t.csv", fr.poses_t)
        r = np.asarray(fr.poses_r).reshape(-1, 9)
        _write_csv_matrix(prefix + f"{num}_rs_r.csv", r)
        for axis, name in enumerate("xyz"):
            _write_csv_matrix(prefix + f"{num}_rs_unproject_{name}.csv",
                              np.asarray(fr.rs_unproject)[..., axis])
            _write_csv_matrix(
                prefix + f"{num}_initial_gs_unproject_{name}.csv",
                np.asarray(fr.gs_unproject)[..., axis])

    intr = pair.intrinsics
    _write_csv_matrix(prefix + "A.csv", intr.matrix(np.float64))
    _write_csv_matrix(os.path.join(task_dir, "gamma.csv"),
                      np.asarray([[pair.gamma]]))
    _write_csv_matrix(os.path.join(task_dir, "k.csv"),
                      np.asarray([[pair.k]]))
    _write_csv_matrix(os.path.join(task_dir, "v.csv"),
                      np.asarray(pair.v)[None, :])
    _write_csv_matrix(os.path.join(task_dir, "w.csv"),
                      np.asarray(pair.w)[None, :])
    return prefix


def load_synthetic_pair(task_dir: str) -> PairData:
    """Load a synthetic pair + GT from the reference's sweep-task layout."""
    prefix = os.path.join(task_dir, "images", "")

    def load_frame(num: str) -> FrameData:
        rs = _imread(prefix + f"{num}_rs.png")[..., :3]
        gs_path = prefix + f"{num}_initial_gs.png"
        gs = _imread(gs_path)[..., :3] if os.path.exists(gs_path) else None
        dep_path = prefix + f"{num}_initial_depth.png"
        dep = _imread(dep_path) if os.path.exists(dep_path) else None
        t = _read_csv_matrix(prefix + f"{num}_rs_t.csv")
        r = _read_csv_matrix(prefix + f"{num}_rs_r.csv").reshape(-1, 3, 3)
        h, w = rs.shape[:2]
        if r.shape[0] != h or t.shape[0] != h:
            raise ValueError(
                f"pose CSV rows ({r.shape[0]}/{t.shape[0]}) do not match "
                f"scanline count {h}")
        un = np.stack(
            [_read_csv_matrix(prefix + f"{num}_rs_unproject_{n}.csv")
             for n in "xyz"], axis=-1)
        gs_un_path = prefix + f"{num}_initial_gs_unproject_x.csv"
        gs_un = None
        if os.path.exists(gs_un_path):
            gs_un = np.stack(
                [_read_csv_matrix(
                    prefix + f"{num}_initial_gs_unproject_{n}.csv")
                 for n in "xyz"], axis=-1)
        if un.shape[:2] != (h, w):
            raise ValueError(
                f"unprojection map {un.shape[:2]} does not match image "
                f"size {(h, w)}")
        return FrameData(rs_image=rs, gs_image=gs, depth_image=dep,
                         poses_r=r, poses_t=t, rs_unproject=un,
                         gs_unproject=gs_un)

    k_mat = _read_csv_matrix(prefix + "A.csv")
    intr = Intrinsics.from_matrix(k_mat)

    def maybe_scalar(name):
        p = os.path.join(task_dir, name)
        return float(_read_csv_matrix(p)[0, 0]) if os.path.exists(p) else None

    def maybe_vec(name):
        p = os.path.join(task_dir, name)
        return (_read_csv_matrix(p).reshape(-1)
                if os.path.exists(p) else None)

    return PairData(
        frame1=load_frame("1"), frame2=load_frame("2"), intrinsics=intr,
        gamma=maybe_scalar("gamma.csv"), k=maybe_scalar("k.csv"),
        v=maybe_vec("v.csv"), w=maybe_vec("w.csv"))


def load_real_pair(data_prefix: str, intrinsics: Intrinsics) -> PairData:
    """Real-world pair: frame{1,2}.png + named intrinsics
    (setupCameraReal, src/main.cc:675-690)."""
    f1 = _imread(os.path.join(data_prefix, "frame1.png"))[..., :3]
    f2 = _imread(os.path.join(data_prefix, "frame2.png"))[..., :3]
    mk = lambda img: FrameData(rs_image=img, gs_image=None, depth_image=None,
                               poses_r=None, poses_t=None, rs_unproject=None,
                               gs_unproject=None)
    return PairData(frame1=mk(f1), frame2=mk(f2), intrinsics=intrinsics)


def true_depth_from_unprojection(unproj, poses_r, poses_t) -> np.ndarray:
    """GT depth map: camera z of each unprojection point under its scanline
    pose (RsFrame::setSyntheticDepthMapRs, src/rsframe.cc:565-615)."""
    cam_z = (np.einsum("hij,hwj->hwi", poses_r, unproj)
             + poses_t[:, None, :])[..., 2]
    hit = np.linalg.norm(unproj, axis=-1) > 0
    return np.where(hit, cam_z, 0.0)
