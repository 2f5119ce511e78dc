"""Dump full-HD flow fields + occlusion masks for offline error analysis.

Usage:
  python scripts/flow_dump.py
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

H, W = 1080, 1920
SCENES = ["castle_clean", "castle_photo", "stress"]


def main():
    import jax

    from rs_sfm_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()
    import jax.numpy as jnp

    from rs_sfm_tpu.flow.dense import DenseFlowConfig, flow_forward_backward

    base = DenseFlowConfig()
    variants = {
        "r16nofine": base._replace(refine_fine_radius=0),
        "lcnnofine": base._replace(lcn=0.05, refine_fine_radius=0),
        "gaincorr": base._replace(gain_correct=True),
    }
    outdir = os.path.join(REPO, "results", "flow_dump")
    os.makedirs(outdir, exist_ok=True)
    for name, cfg in variants.items():
        fb = jax.jit(lambda a, b, c=cfg: flow_forward_backward(a, b, c))
        for s in SCENES:
            out = os.path.join(outdir, f"{name}_{s}.npz")
            if os.path.exists(out):
                continue
            p = os.path.join(REPO, "results", "stress_cache",
                             f"stress_{H}x{W}_{s}_v2.npz")
            if not os.path.exists(p):
                p = os.path.join(REPO, "results", "stress_cache",
                                 f"stress_{H}x{W}_{s}.npz")
            with np.load(p) as z:
                i1, i2 = jnp.asarray(z["i1"]), jnp.asarray(z["i2"])
            r = fb(i1, i2)
            np.savez_compressed(out, flow=np.asarray(r.flow),
                                occ=np.asarray(r.occlusion))
            print("wrote", out, flush=True)


if __name__ == "__main__":
    main()
