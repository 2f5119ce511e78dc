"""Dense optical-flow model presets.

The reference has exactly one interchangeable "model": the dense flow
estimator (OpenCV DeepFlow, src/camera.cc:253-277), with ground-truth
reprojection flow as its drop-in test double (src/camera.cc:209-249).  This
package keeps that seam explicit as a registry of named DenseFlowConfig
presets, selectable via `--flow-model` on the CLI and `flow_cfg` in the
evaluation harness:

  variational  pyramidal warping flow (DeepFlow-class; flow/dense.py)
  fast         low-iteration variational preset for previews/video
  robust       local-contrast-normalized data term (gain/offset-invariant)
               for real imagery with exposure/vignetting changes — the
               production robust preset (STRESS.md: passes the full-HD
               photometric + mover stress gates; fused-SOR compatible)
  census       ternary-census data term + structure-texture (experimental:
               measured UNRELIABLE at full-HD — the fixed soft-sign scale
               over-amplifies fine-scale noise; see STRESS.md — kept as
               the research seam for census-family terms)
  auto         per-pair selection between variational and robust via a
               cheap coarse-scale probe (flow/auto.py) — the
               one-configuration UX of the reference; resolve with
               resolve_flow_preset(name, image1, image2)
"""

from __future__ import annotations

from typing import Dict

from rs_sfm_tpu.flow.dense import DenseFlowConfig

# Both production presets run 6 warping iterations at the COARSE
# pyramid levels (finest stays at 3).  Extra coarse relinearizations are
# where wrong basins around movers/large motions get corrected (measured,
# results/flow_matrix_r5.json and STRESS.md: mover-scene median EPE
# 12.7 -> 4.7 px plain, photo 2.61 -> 1.76, bigmotion 0.24 -> 0.11).
FLOW_PRESETS: Dict[str, DenseFlowConfig] = {
    "variational": DenseFlowConfig(warps_coarse=6),
    "fast": DenseFlowConfig(levels=4, warps=2, iters=24),
    "robust": DenseFlowConfig(lcn=0.05, warps_coarse=6),
    "census": DenseFlowConfig(census_weight=1.0, struct_texture=0.9),
}


def get_flow_preset(name: str, **overrides) -> DenseFlowConfig:
    """Look up a flow preset by name, optionally overriding fields
    (e.g. ``get_flow_preset("robust", backward_scale=2)``).

    "auto" requires the frame pair — use resolve_flow_preset."""
    try:
        preset = FLOW_PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown flow model {name!r}; known: "
            f"{sorted(FLOW_PRESETS) + ['auto']}"
        ) from None
    return preset._replace(**overrides) if overrides else preset


def resolve_flow_preset(name: str, image1=None, image2=None, **overrides):
    """Resolve a preset name — including "auto" — to a DenseFlowConfig.

    "auto" runs the coarse-scale probe (flow/auto.py) on the pair and
    picks plain vs robust, restoring the reference's one-configuration UX
    (src/main.cc:304-311) without per-scene flags.

    Returns:
      (config, resolved_name).
    """
    if name == "auto":
        if image1 is None or image2 is None:
            raise ValueError("flow preset 'auto' needs the frame pair")
        from rs_sfm_tpu.flow.auto import probe_flow_preset

        name = probe_flow_preset(image1, image2)
    return get_flow_preset(name, **overrides), name
