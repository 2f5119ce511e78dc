"""Evaluation: error metrics and the sweep harness.

JAX equivalents of the reference's error_measure
(src/errorMeasure.{h,cpp}) and Camera::meanReprojectionError
(src/camera.cc:593-691): jitted metrics over full pixel grids, a harness
driver reproducing the evaluateVelocities protocol, and artifact writers.
"""

from rs_sfm_tpu.eval.metrics import (mean_reprojection_error,
                                     rotation_error, translation_error)
