"""Round-5 flow quality matrix: candidate production-preset changes.

Measures, per probe scene (its auto-selected preset family) and per
candidate config, rigid-pixel EPE stats and (for the headline configs)
the production-config estimation error.  Decides:

  * warps_coarse=6 + refine_search_radius=8 — the stress-scene lever
    (measured interactively: med 12.7 -> 2.1 px) — regression-free on
    the other scenes?
  * refine_shifted=True — the discrete-refine cost collapse — EPE-neutral
    for the smooth-flow presets?

Writes results/flow_matrix_r5.json.  CPU or GPU (ambient platform).
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "results", "flow_matrix_r5.json")

H, W = 1080, 1920
SCENES = ["castle_clean", "castle_photo", "stress", "bigmotion", "reptex"]
PRESET = {"castle_clean": "variational", "castle_photo": "robust",
          "stress": "robust", "bigmotion": "variational",
          "reptex": "variational"}


def main():
    import jax

    from rs_sfm_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()
    import jax.numpy as jnp

    from rs_sfm_tpu.config import PipelineConfig
    from rs_sfm_tpu.data.synthetic import default_intrinsics
    from rs_sfm_tpu.eval.metrics import translation_error
    from rs_sfm_tpu.flow.dense import flow_forward_backward
    from rs_sfm_tpu.models import get_flow_preset
    from rs_sfm_tpu.solver.pipeline import estimate_from_flow


    out = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            out = json.load(f)

    def save():
        with open(OUT, "w") as f:
            json.dump(out, f, indent=1)

    intr = default_intrinsics(H, W)
    est_cfg = PipelineConfig(ransac_trials=256, ransac_tol=0.02,
                             refine_iterations=20, refine_starts=4,
                             refine_winnow_iters=8, refine_rel_tol=0.0,
                             depth_residual_px=2.0,
                             refine_loss_delta_px=3.0)

    def variants(preset):
        base = get_flow_preset(preset)
        return {
            "r4prod": base,
            "shifted": base._replace(refine_shifted=True),
            "wc6r8": base._replace(warps_coarse=6, refine_search_radius=8,
                                   refine_shifted=True),
            "wc6r8_exact": base._replace(warps_coarse=6,
                                         refine_search_radius=8),
        }

    EST_FOR = ("r4prod", "wc6r8")

    for scene in SCENES:
        path = os.path.join(REPO, "results", "stress_cache",
                            f"stress_{H}x{W}_{scene}_v2.npz")
        with np.load(path) as z:
            i1, i2 = z["i1"], z["i2"]
            gt = z["gt_flow"]
            mover = (z["mover"] if "mover" in z.files
                     else np.zeros(gt.shape[:2], bool))
            v_t = z["v"]
        g = lambda im: (0.299 * im[..., 0] + 0.587 * im[..., 1]
                        + 0.114 * im[..., 2]) if im.ndim == 3 else im
        g1 = jnp.asarray(g(i1), jnp.float32)
        g2 = jnp.asarray(g(i2), jnp.float32)
        rigid = ~mover & (np.linalg.norm(gt, axis=-1) > 0)
        row = out.get(scene, {})
        for cname, cfgv in variants(PRESET[scene]).items():
            if cname in row:
                print(scene, cname, "(cached)", flush=True)
                continue
            t0 = time.perf_counter()
            fb = flow_forward_backward(g1, g2, cfgv)
            f = np.asarray(fb.flow)
            dt = time.perf_counter() - t0
            occ = np.asarray(fb.occlusion)
            epe = np.linalg.norm(f - gt, axis=-1)
            rec = {
                "epe_med": float(np.median(epe[rigid])),
                "epe_frac2": float((epe[rigid] < 2).mean()),
                "epe_unocc_mean": float(epe[rigid & ~occ].mean()),
                "occ_frac": float(occ.mean()),
                "amb_frac": float(np.asarray(fb.ambiguous).mean()),
                "wall_s": round(dt, 1),
            }
            if cname in EST_FOR:
                res = estimate_from_flow(fb.flow, intr, 0.9, est_cfg,
                                         jax.random.PRNGKey(0),
                                         pixel_mask=~fb.occlusion)
                rec["err_v"] = float(translation_error(
                    res.v, jnp.asarray(v_t, jnp.float32)))
            row[cname] = rec
            out[scene] = row
            save()
            print(scene, cname, json.dumps(rec), flush=True)

    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
