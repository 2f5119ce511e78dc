"""Geometry core: SO(3), pinhole camera model, RS per-scanline pose model.

JAX replacement for the reference's L1 layer (Scanline/RsFrame,
reference src/scanline.h, src/rsframe.h): instead of per-scanline objects,
poses are dense arrays (H, 3, 3) / (H, 3) and every transform is a pure
vmappable function over pixel/scanline batches.
"""

from rs_sfm_tpu.geom.so3 import hat, vee, exp_first_order
from rs_sfm_tpu.geom.camera import Intrinsics
from rs_sfm_tpu.geom import rspose
