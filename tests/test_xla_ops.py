"""The XLA hot-path operators against plain numpy references: the
bilinear warp and 3x3 median of the flow solver, and the RANSAC
hypothesis scorer."""

import numpy as np
import jax.numpy as jnp
import pytest

from rs_sfm_tpu.flow.dense import _median3, _warp
from rs_sfm_tpu.solver.ransac import _score_hypotheses


def _bilinear_ref(img, flow):
    """Per-pixel loop: sample img at (x + u, y + v), coordinates clamped to
    the image, bilinear between the four neighbors."""
    h, w = img.shape
    out = np.zeros((h, w))
    for y in range(h):
        for x in range(w):
            sx = min(max(x + flow[y, x, 0], 0.0), w - 1.0)
            sy = min(max(y + flow[y, x, 1], 0.0), h - 1.0)
            x0, y0 = int(np.floor(sx)), int(np.floor(sy))
            x1, y1 = min(x0 + 1, w - 1), min(y0 + 1, h - 1)
            fx, fy = sx - x0, sy - y0
            out[y, x] = ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x1])
                         + fy * ((1 - fx) * img[y1, x0] + fx * img[y1, x1]))
    return out


@pytest.mark.parametrize("case", ["smooth", "constant", "out_of_bounds"])
def test_warp_matches_bilinear_reference(case):
    rng = np.random.default_rng(3)
    h, w = 23, 37
    img = rng.uniform(size=(h, w))
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    if case == "smooth":
        flow = np.stack([2.5 * np.sin(ys / 5.0), 1.7 * np.cos(xs / 7.0)], -1)
    elif case == "constant":
        flow = np.broadcast_to([3.25, -1.5], (h, w, 2)).copy()
    else:
        # Samples far outside the image clamp to its edge.
        flow = rng.uniform(-60.0, 60.0, size=(h, w, 2))
    out = np.asarray(_warp(jnp.asarray(img, jnp.float32),
                           jnp.asarray(flow, jnp.float32)))
    np.testing.assert_allclose(out, _bilinear_ref(img, flow), atol=2e-5)


@pytest.mark.parametrize("shape", [(9, 13), (40, 31)])
def test_median3_matches_numpy(shape):
    rng = np.random.default_rng(5)
    x = rng.normal(size=shape).astype(np.float32)
    padded = np.pad(x, 1, mode="edge")
    windows = np.stack([padded[dy:dy + shape[0], dx:dx + shape[1]]
                        for dy in range(3) for dx in range(3)])
    np.testing.assert_array_equal(np.asarray(_median3(jnp.asarray(x))),
                                  np.median(windows, axis=0))


def _score_ref(coords, flow, alpha, alpha_k, valid, v, w, k, tol):
    """float64 numpy: closed-form ρ per pixel, predicted flow, inlier vote
    and summed inlier error per hypothesis."""
    x, y = coords[:, 0], coords[:, 1]
    nums, errs = [], []
    for vh, wh, kh in zip(v, w, k):
        beta = (alpha + kh * alpha_k) * (2.0 / (2.0 + kh))
        a = np.stack([vh[0] - x * vh[2], vh[1] - y * vh[2]], -1)
        b = np.stack([-x * y * wh[0] + (1 + x * x) * wh[1] - y * wh[2],
                      -(1 + y * y) * wh[0] + x * y * wh[1] + x * wh[2]], -1)
        g = beta[:, None] * a
        rhs = flow - beta[:, None] * b
        gg = np.sum(g * g, -1)
        rho = np.where(gg != 0, np.sum(g * rhs, -1) / np.where(gg != 0, gg, 1),
                       0.0)
        err = np.linalg.norm(beta[:, None] * (a * rho[:, None] + b) - flow,
                             axis=-1)
        inl = (err < tol) & valid
        nums.append(int(inl.sum()))
        errs.append(float(err[inl].sum()))
    return np.asarray(nums), np.asarray(errs)


@pytest.mark.parametrize("t", [16, 40])
def test_ransac_scorer_matches_numpy(t):
    rng = np.random.default_rng(t)
    n = 4096
    coords = rng.uniform(-0.5, 0.5, size=(n, 2))
    v_true = np.array([0.02, -0.01, 0.015])
    w_true = np.array([0.004, -0.002, 0.008])
    rho = 1.0 / rng.uniform(3.0, 9.0, size=n)
    alpha = 1.0 + rng.normal(scale=0.01, size=n)
    alpha_k = 0.5 * alpha * alpha + rng.normal(scale=0.01, size=n)
    x, y = coords[:, 0], coords[:, 1]
    flow = np.stack([
        (v_true[0] - x * v_true[2]) * rho - x * y * w_true[0]
        + (1 + x * x) * w_true[1] - y * w_true[2],
        (v_true[1] - y * v_true[2]) * rho - (1 + y * y) * w_true[0]
        + x * y * w_true[1] + x * w_true[2]], -1) * alpha[:, None]
    flow[: n // 5] += rng.normal(scale=5e-3, size=(n // 5, 2))  # outliers
    valid = rng.uniform(size=n) > 0.1
    v = v_true + rng.normal(scale=3e-3, size=(t, 3))
    w = w_true + rng.normal(scale=5e-4, size=(t, 3))
    k = rng.uniform(-0.2, 0.4, size=t)
    tol = 1e-3
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    num, ierr, _, _ = _score_hypotheses(
        f32(coords), f32(flow), f32(alpha), f32(alpha_k), jnp.asarray(valid),
        f32(v), f32(w), f32(k), tol)
    num_r, err_r = _score_ref(coords, flow, alpha, alpha_k, valid, v, w, k,
                              tol)
    assert num_r.max() > 0.5 * n  # the hypotheses have real support
    # float32 vs float64: only pixels within rounding of the threshold
    # may flip.
    assert np.abs(np.asarray(num) - num_r).max() <= 3, (num, num_r)
    np.testing.assert_allclose(np.asarray(ierr), err_r, rtol=5e-3)
