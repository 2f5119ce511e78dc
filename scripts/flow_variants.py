"""Full-HD dense-flow variant diagnostic: EPE per configuration.

Measures, on the cached full-HD stress scenes (scripts/stress_fullhd.py
--phase render), the rigid-pixel EPE / occlusion stats / wall-clock of a
set of DenseFlowConfig variants — used to attribute full-HD flow error to
individual mechanisms (warp-kernel residual clamping, fine-level discrete
refine, coarse-init search radius, census) before committing a production
preset.  Writes results/flow_variants.json.

Usage:
  python scripts/flow_variants.py [--variants a,b,...] [--scenes s,...]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

H, W = 1080, 1920
SCENES = ["castle_clean", "castle_photo", "stress"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=None)
    ap.add_argument("--scenes", default=None)
    ap.add_argument("--cache", default=os.path.join(REPO, "results",
                                                    "stress_cache"))
    ap.add_argument("--out", default=os.path.join(REPO, "results",
                                                  "flow_variants.json"))
    args = ap.parse_args()

    import jax

    from rs_sfm_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()
    import jax.numpy as jnp

    from rs_sfm_tpu.flow.dense import DenseFlowConfig, flow_forward_backward

    base = DenseFlowConfig()
    variants = {
        # current production plain path (with fine-level refine r=2 default)
        "plain": base,
        # no fine-level refine (round-2 behavior above 192 px)
        "nofine": base._replace(refine_fine_radius=0),
        # larger coarse-init search (stress slab moves ~390 px > 8·2^5)
        "init12": base._replace(init_search_radius=12),
        # census robust preset, current form
        "census": DenseFlowConfig(census_weight=1.0, struct_texture=0.9),
        # --- batch 2 ---
        "r16base": base,
        "r16nofine": base._replace(refine_fine_radius=0),
        "lcn": base._replace(lcn=0.05),
        "lcnnofine": base._replace(lcn=0.05, refine_fine_radius=0),
        "lcninit12": base._replace(lcn=0.05, init_search_radius=12),
        # census rehabilitation probe: census on LCN-normalized images
        # (unit-scale: sigma 0.5 sits at the intended soft-sign knee)
        "census2": DenseFlowConfig(census_weight=1.0,
                                   lcn=0.05, census_sigma=0.5,
                                   brightness_weight=0.5),
        # --- round 4 ---
        # cheaper non-finest levels (r4 pyramid-tail cut candidate)
        "coarse2": base._replace(warps_coarse=2, iters_coarse=12),
        "robust_coarse2": base._replace(lcn=0.05, warps_coarse=2,
                                        iters_coarse=12),
        # robust preset on the adversarial probes
        "robust": base._replace(lcn=0.05),
        # NCC-style matching (contrast-normalized patches) on the probes
        "gaincorr2": base._replace(gain_correct=True),
        # wider coarse search for the big-motion probe
        "init12b": base._replace(init_search_radius=12),
        # ambiguity (ratio) test in the discrete matching: repetitive
        # texture defers to the variational continuation
        "ratio08": base._replace(match_ratio=0.8),
        "ratio09": base._replace(match_ratio=0.9),
    }
    names = (args.variants.split(",") if args.variants else list(variants))
    scenes = (args.scenes.split(",") if args.scenes else SCENES)

    out = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            out = json.load(f)

    data = {}
    for s in scenes:
        # stress_fullhd.py --phase render writes the *_v2.npz cache files
        # (extra GT-pose/depth keys are ignored here); fall back to the
        # legacy name for pre-v2 caches.
        p = os.path.join(args.cache, f"stress_{H}x{W}_{s}_v2.npz")
        if not os.path.exists(p):
            p = os.path.join(args.cache, f"stress_{H}x{W}_{s}.npz")
        with np.load(p) as z:
            data[s] = {k: z[k] for k in z.files}

    for name in names:
        cfg = variants[name]
        fb = jax.jit(lambda a, b, c=cfg: flow_forward_backward(a, b, c))
        for s in scenes:
            key = f"{name}/{s}"
            if key in out:
                print(f"skip {key}", flush=True)
                continue
            i1 = jnp.asarray(data[s]["i1"])
            i2 = jnp.asarray(data[s]["i2"])
            t0 = time.perf_counter()
            r = fb(i1, i2)
            jax.block_until_ready(r.flow)
            compile_s = time.perf_counter() - t0
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                r = fb(i1, i2)
                jax.block_until_ready(r.flow)
                ts.append(time.perf_counter() - t0)
            f = np.asarray(r.flow)
            occ = np.asarray(r.occlusion)
            gt = data[s]["gt_flow"]
            mover = data[s]["mover"]
            rigid = ~mover & (np.linalg.norm(gt, axis=-1) > 0)
            epe = np.linalg.norm(f - gt, axis=-1)
            row = {
                "epe_all": float(epe[rigid].mean()),
                "epe_unocc": float(epe[rigid & ~occ].mean()),
                "epe_med": float(np.median(epe[rigid])),
                "occ_frac": float(occ.mean()),
                "ms": round(min(ts) * 1e3, 1),
                "compile_s": round(compile_s, 1),
            }
            if mover.any():
                row["mover_flag"] = float(occ[mover].mean())
            out[key] = row
            print(key, json.dumps(row), flush=True)
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as fo:
                json.dump(out, fo, indent=1)
    print("done")


if __name__ == "__main__":
    main()
