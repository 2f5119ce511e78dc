"""Classical dense-flow baseline: ours vs OpenCV DIS / Farneback.

SURVEY §2.3 sets the flow bar as "quality >= DeepFlow on the example
pairs" (the reference's flow stage, /root/reference/src/camera.cc:253-277).
DeepFlow itself lives in opencv-contrib (absent here), but cv2 5.0 ships
two classical dense baselines — DIS (the strongest classical method of
the post-DeepFlow generation) and Farneback — so the claim becomes a
measured EPE table on the five full-HD probe scenes (VERDICT r4 item 6).

Protocol: for each cached probe scene, run each method on the same gray
pairs and report EPE over rigid (non-mover) pixels: mean / median, plus
wall-clock.  Ours = the production preset the auto probe picks for that
scene (plain on clean/bigmotion, robust on photo/stress; reptex is the
documented adversarial failure for every local matcher).

CPU-only (cv2 runs on host); ours is timed on the GPU by bench.py — the
wall-clock column here is for scale, not a device comparison.

Writes results/flow_baseline_cv.json (table transcribed into STRESS.md).
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "results", "flow_baseline_cv.json")

H, W = 1080, 1920
SCENES = ["castle_clean", "castle_photo", "stress", "bigmotion", "reptex"]
PRESET = {"castle_clean": "variational", "castle_photo": "robust",
          "stress": "robust", "bigmotion": "variational",
          "reptex": "variational"}


def _path(scene):
    return os.path.join(REPO, "results", "stress_cache",
                        f"stress_{H}x{W}_{scene}_v2.npz")


def main():
    import cv2
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from rs_sfm_tpu.flow.dense import flow_forward_backward
    from rs_sfm_tpu.models import get_flow_preset

    out = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            out = json.load(f)

    def save():
        with open(OUT, "w") as f:
            json.dump(out, f, indent=1)

    def epe_stats(flow, gt, mask):
        epe = np.linalg.norm(flow - gt, axis=-1)[mask]
        return {"epe_mean": float(epe.mean()),
                "epe_med": float(np.median(epe))}

    def run_dis(g1, g2, preset, finest=None, var_iters=None):
        dis = cv2.DISOpticalFlow_create(preset)
        if finest is not None:
            dis.setFinestScale(finest)   # 0 = full resolution
        if var_iters is not None:
            dis.setVariationalRefinementIterations(var_iters)
        return dis.calc((g1 * 255).astype(np.uint8),
                        (g2 * 255).astype(np.uint8), None)

    def run_farneback(g1, g2):
        return cv2.calcOpticalFlowFarneback(
            (g1 * 255).astype(np.uint8), (g2 * 255).astype(np.uint8),
            None, pyr_scale=0.5, levels=6, winsize=21, iterations=5,
            poly_n=7, poly_sigma=1.5, flags=0)

    for scene in SCENES:
        path = _path(scene)
        if not os.path.exists(path):
            print(f"skip {scene}: no cached render ({path})")
            continue
        with np.load(path) as z:
            i1 = z["i1"]
            i2 = z["i2"]
            gt = z["gt_flow"]
            mover = z["mover"] if "mover" in z.files else np.zeros(
                gt.shape[:2], bool)
        g1 = (0.299 * i1[..., 0] + 0.587 * i1[..., 1] + 0.114 * i1[..., 2]
              if i1.ndim == 3 else i1).astype(np.float32)
        g2 = (0.299 * i2[..., 0] + 0.587 * i2[..., 1] + 0.114 * i2[..., 2]
              if i2.ndim == 3 else i2).astype(np.float32)
        rigid = ~mover & (np.linalg.norm(gt, axis=-1) > 0)
        row = out.get(scene, {})

        for name, fn in (
            ("dis_medium", lambda: run_dis(
                g1, g2, cv2.DISOPTICAL_FLOW_PRESET_MEDIUM)),
            ("dis_strong", lambda: run_dis(
                g1, g2, cv2.DISOPTICAL_FLOW_PRESET_MEDIUM, finest=0,
                var_iters=25)),
            ("farneback", lambda: run_farneback(g1, g2)),
        ):
            if name in row:
                continue
            t0 = time.perf_counter()
            fl = fn()
            dt = time.perf_counter() - t0
            row[name] = dict(epe_stats(fl, gt, rigid),
                             ms=round(dt * 1e3, 1))
            out[scene] = row
            save()
            print(scene, name, json.dumps(row[name]), flush=True)

        if "ours" not in row:
            cfg = get_flow_preset(PRESET[scene])
            t0 = time.perf_counter()
            fb = flow_forward_backward(jnp.asarray(g1), jnp.asarray(g2),
                                       cfg)
            fl = np.asarray(fb.flow)
            dt = time.perf_counter() - t0
            row["ours"] = dict(epe_stats(fl, gt, rigid),
                               ms=round(dt * 1e3, 1),
                               preset=PRESET[scene],
                               note="CPU wall-clock incl. compile; GPU "
                                    "time is bench.py's")
            occ = np.asarray(fb.occlusion)
            row["ours"]["epe_unocc_mean"] = float(
                np.linalg.norm(fl - gt, axis=-1)[rigid & ~occ].mean())
            out[scene] = row
            save()
            print(scene, "ours", json.dumps(row["ours"]), flush=True)

        if "ours_feedback" not in row:
            # The production flow PRODUCT: model-feedback corrected flow
            # (untrusted pixels replaced by the rigid-model prediction
            # from inpainted depth) — the system-level capability DIS has
            # no analog of.  Movers stay untrusted (they fit no rigid
            # model); their flow is model-substituted, which is the right
            # answer for rectification but "wrong" vs the mover's GT
            # flow, so the table scores RIGID pixels only, like every
            # other row.
            from rs_sfm_tpu.config import PipelineConfig
            from rs_sfm_tpu.flow.dense import flow_forward_backward
            from rs_sfm_tpu.flow.feedback import model_feedback
            from rs_sfm_tpu.data.synthetic import default_intrinsics
            from rs_sfm_tpu.solver.pipeline import estimate_from_flow

            intr = default_intrinsics(H, W)
            cfgp = PipelineConfig(ransac_trials=256, ransac_tol=0.02,
                                  refine_iterations=20, refine_starts=4,
                                  refine_winnow_iters=8,
                                  refine_rel_tol=0.0,
                                  depth_residual_px=2.0,
                                  refine_loss_delta_px=3.0)
            cfgf = get_flow_preset(PRESET[scene])
            fb = flow_forward_backward(jnp.asarray(g1), jnp.asarray(g2),
                                       cfgf)
            import jax as _jax

            res = estimate_from_flow(fb.flow, intr, 0.9, cfgp,
                                     _jax.random.PRNGKey(0),
                                     pixel_mask=~fb.occlusion)
            fbk = model_feedback(fb.flow, fb.occlusion, res, intr, 0.9,
                                 cfgp)
            row["ours_feedback"] = dict(
                epe_stats(np.asarray(fbk.flow), gt, rigid),
                untrusted_frac=float(np.asarray(fbk.occlusion).mean()))
            out[scene] = row
            save()
            print(scene, "ours_feedback", json.dumps(row["ours_feedback"]),
                  flush=True)

    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
