"""XLA Schur-LM refinement (solver/refine.py) and the multi-start
pipeline schedules built on it (f32, like the production path)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rs_sfm_tpu.solver.beta import get_alpha, get_alpha_k
from rs_sfm_tpu.solver.flow_model import predict_flow
from rs_sfm_tpu.solver.refine import refine


def _problem(n=512, seed=0, k_true=0.3):
    rng = np.random.default_rng(seed)
    f = 500.0
    h = 600
    gamma = 0.9
    px = rng.uniform(0, 599, size=(n, 2))
    coords = jnp.asarray((px - 300.0) / f, jnp.float32)
    v = jnp.asarray([0.02, -0.01, 0.015], jnp.float32)
    w = jnp.asarray([0.004, -0.002, 0.008], jnp.float32)
    rho = jnp.asarray(1.0 / rng.uniform(3.0, 9.0, size=n), jnp.float32)
    alpha = jnp.asarray(
        get_alpha(rng.normal(scale=2.0, size=n), h, gamma), jnp.float32)
    alpha_k = jnp.asarray(
        get_alpha_k(px[:, 1], rng.normal(scale=2.0, size=n), h, gamma),
        jnp.float32)
    flow = predict_flow(coords, rho, v, w, k_true, alpha, alpha_k)
    noise = jnp.asarray(rng.normal(scale=2e-4, size=(n, 2)), jnp.float32)
    return coords, flow + noise, alpha, alpha_k, v, w, rho, k_true


def _angle(a, b):
    a = np.asarray(a) / np.linalg.norm(a)
    b = np.asarray(b) / np.linalg.norm(b)
    return float(np.arccos(np.clip(abs(a @ b), 0.0, 1.0)))


def test_refine_perturbed_start_converges():
    """A far start with weak damping forces early LM rejections; the
    accept/re-damp cycle must still converge."""
    coords, flow, alpha, alpha_k, v, w, rho, k_true = _problem(seed=3)
    mask = jnp.ones(coords.shape[0], dtype=bool)
    for init_lambda in (1e-6, 1e-7):
        r = refine(coords, flow, alpha, alpha_k, mask, v * 2.0 + 0.01,
                   w * 0.0, jnp.float32(0.8), rho * 2.0, optimize_k=True,
                   iterations=40, init_lambda=init_lambda)
        assert np.isfinite(float(r.cost))
        assert float(r.cost) < 0.05 * float(r.initial_cost), (
            init_lambda, float(r.cost), float(r.initial_cost))
        assert _angle(r.v, v) < 0.05, (init_lambda, _angle(r.v, v))


@pytest.mark.parametrize("optimize_k", [False, True])
def test_refine_optimize_k(optimize_k):
    """Perturbed (v, w, ρ) — and k when it is optimized — return to the
    truth; with k frozen, k stays exactly at its start."""
    coords, flow, alpha, alpha_k, v, w, rho, k_true = _problem()
    mask = jnp.ones(coords.shape[0], dtype=bool)
    k0 = jnp.float32(0.0 if optimize_k else k_true)
    r = refine(coords, flow, alpha, alpha_k, mask, v * 1.1 + 0.003,
               w * 0.9, k0, rho * 1.2, optimize_k=optimize_k,
               iterations=25)
    assert float(r.cost) < 0.5 * float(r.initial_cost)
    assert _angle(r.v, v) < 2e-2, _angle(r.v, v)
    np.testing.assert_allclose(np.asarray(r.w), np.asarray(w), atol=5e-4)
    if optimize_k:
        assert abs(float(r.k) - k_true) < 0.05, float(r.k)
    else:
        assert float(r.k) == float(k0)


def test_refine_huber_beats_l2_on_outliers():
    """Huber-IRLS (loss_delta > 0) must downweight a coherent block of
    wrong flow that biases the plain L2 fit."""
    coords, flow, alpha, alpha_k, v, w, rho, k_true = _problem(seed=9)
    flow = flow.at[:64].add(jnp.asarray([3e-3, -2e-3], jnp.float32))
    mask = jnp.ones(coords.shape[0], dtype=bool)
    args = (coords, flow, alpha, alpha_k, mask, v * 1.3, w * 0.7,
            jnp.float32(0.2), rho * 1.1)
    hub = refine(*args, optimize_k=True, iterations=25, loss_delta=1e-3)
    l2 = refine(*args, optimize_k=True, iterations=25)
    assert np.isfinite(float(hub.cost))
    assert _angle(hub.v, v) <= _angle(l2.v, v) + 1e-6, (
        _angle(hub.v, v), _angle(l2.v, v))


def test_refine_vmap_multistart_equals_per_start():
    """The pipeline's batched multi-start is a vmap of refine: each start
    must reproduce its own single refinement (the starts only share the
    pixel record)."""
    coords, flow, alpha, alpha_k, v, w, rho, k_true = _problem(seed=5)
    n = coords.shape[0]
    rng = np.random.default_rng(7)
    masks = jnp.asarray(rng.uniform(size=(3, n)) > 0.2)
    v0 = jnp.asarray(np.asarray(v)[None] * [[1.0], [1.4], [0.7]],
                     jnp.float32)
    w0 = jnp.asarray(np.asarray(w)[None] * [[1.0], [0.5], [1.5]],
                     jnp.float32)
    k0 = jnp.asarray([0.3, 0.1, 0.6], jnp.float32)
    rho0 = jnp.asarray(np.asarray(rho)[None]
                       * rng.uniform(0.8, 1.2, size=(3, 1)), jnp.float32)

    def one(m, a, b, c, d):
        return refine(coords, flow, alpha, alpha_k, m, a, b, c, d,
                      optimize_k=True, iterations=12)

    multi = jax.vmap(one)(masks, v0, w0, k0, rho0)
    for s in range(3):
        single = one(masks[s], v0[s], w0[s], k0[s], rho0[s])
        for name in ("cost", "v", "w", "k", "inv_depth"):
            np.testing.assert_allclose(
                np.asarray(getattr(multi, name)[s]),
                np.asarray(getattr(single, name)), rtol=1e-5, atol=1e-7,
                err_msg=f"start {s} {name}")


def test_pipeline_multistart_batched_recovers_motion():
    """estimate_from_flow with refine_starts>1 (the batched multi-start
    path) still recovers the true motion on synthetic flow."""
    from rs_sfm_tpu.config import PipelineConfig
    from rs_sfm_tpu.geom.camera import Intrinsics
    from rs_sfm_tpu.solver.pipeline import estimate_from_flow
    from rs_sfm_tpu.eval.metrics import translation_error

    rng = np.random.default_rng(11)
    h, w_cols, f = 60, 80, 70.0
    intr = Intrinsics(fx=f, fy=f, cx=w_cols / 2.0, cy=h / 2.0)
    gamma = 0.9
    v_t = jnp.asarray([0.02, -0.01, 0.015], jnp.float32)
    w_t = jnp.asarray([0.003, -0.002, 0.004], jnp.float32)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w_cols, dtype=np.float64), indexing="ij")
    coords = jnp.asarray(
        np.stack([(xs - intr.cx) / f, (ys - intr.cy) / f], -1).reshape(-1, 2),
        jnp.float32)
    depth = jnp.asarray(rng.uniform(4.0, 9.0, size=h * w_cols), jnp.float32)
    # alpha fixed point: flow depends on alpha, alpha on pixel flow_y.
    fl = jnp.zeros((h * w_cols, 2), jnp.float32)
    from rs_sfm_tpu.solver.beta import get_alpha, get_alpha_k
    from rs_sfm_tpu.solver.flow_model import predict_flow

    for _ in range(6):
        a = jnp.asarray(get_alpha(fl[:, 1] * f, h, gamma), jnp.float32)
        ak = jnp.asarray(get_alpha_k(ys.reshape(-1), fl[:, 1] * f, h, gamma),
                         jnp.float32)
        fl = predict_flow(coords, 1.0 / depth, v_t, w_t, 0.0, a, ak)
    flow_px = (fl * f).reshape(h, w_cols, 2)
    cfg = PipelineConfig(ransac_trials=64, ransac_tol=0.01,
                         refine_starts=4, refine_iterations=20)
    res = estimate_from_flow(flow_px, intr, gamma, cfg,
                             jax.random.PRNGKey(0))
    assert float(translation_error(res.v, v_t)) < 0.03
    assert float(jnp.linalg.norm(res.w - w_t)) < 1e-3


def test_pipeline_winnow_matches_full_multistart():
    """refine_winnow_iters: the 2-phase (J starts x few iters -> winner
    alone) schedule must land in the same basin as full J x 30 on a
    well-posed problem (basin ranking is stable long before LM
    convergence)."""
    from rs_sfm_tpu.config import PipelineConfig
    from rs_sfm_tpu.solver.pipeline import estimate_from_flow
    import numpy as _np
    from rs_sfm_tpu.geom.camera import Intrinsics
    from rs_sfm_tpu.solver.beta import get_alpha, get_alpha_k
    from rs_sfm_tpu.solver.flow_model import predict_flow

    rng = _np.random.default_rng(17)
    h, w_cols, f = 60, 80, 70.0
    intr = Intrinsics(fx=f, fy=f, cx=w_cols / 2.0, cy=h / 2.0)
    v_t = jnp.asarray([0.02, -0.01, 0.015], jnp.float32)
    w_t = jnp.asarray([0.003, -0.002, 0.004], jnp.float32)
    ys, xs = _np.meshgrid(_np.arange(h, dtype=_np.float64),
                          _np.arange(w_cols, dtype=_np.float64),
                          indexing="ij")
    coords = jnp.asarray(_np.stack([(xs - intr.cx) / f, (ys - intr.cy) / f],
                                   -1).reshape(-1, 2), jnp.float32)
    depth = jnp.asarray(rng.uniform(4.0, 9.0, size=h * w_cols), jnp.float32)
    fl = jnp.zeros((h * w_cols, 2), jnp.float32)
    for _ in range(6):
        a = jnp.asarray(get_alpha(fl[:, 1] * f, h, 0.9), jnp.float32)
        ak = jnp.asarray(get_alpha_k(ys.reshape(-1), fl[:, 1] * f, h, 0.9),
                         jnp.float32)
        fl = predict_flow(coords, 1.0 / depth, v_t, w_t, 0.0, a, ak)
    flow_px = (fl * f).reshape(h, w_cols, 2)
    base = PipelineConfig(ransac_trials=64, ransac_tol=0.01,
                          refine_starts=4, refine_iterations=30)
    r_full = estimate_from_flow(flow_px, intr, 0.9, base,
                                jax.random.PRNGKey(0))
    r_win = estimate_from_flow(flow_px, intr, 0.9,
                               base.__class__(**{**base.__dict__,
                                                 "refine_winnow_iters": 8}),
                               jax.random.PRNGKey(0))
    np.testing.assert_allclose(np.asarray(r_win.v), np.asarray(r_full.v),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(np.asarray(r_win.w), np.asarray(r_full.w),
                               rtol=0, atol=1e-5)
