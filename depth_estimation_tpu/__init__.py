"""depth_estimation_tpu — a JAX/XLA/Pallas optical-flow + depth framework
with the capabilities of MichaelMathieu/depth-estimation.

Layer map (mirrors SURVEY.md §1):
  geometry / codecs      static config + displacement index codecs
  ops/                   hot compute ops (fused correlation matcher,
                         resampling, confidence extraction, post-filters)
  models/                flow matcher model families (single-scale, multiscale
                         pyramid, radial/polar 1-D)
  data/                  groundtruth generators + patch samplers + image sources
  flow/                  variational (Ce Liu style) coarse-to-fine flow in JAX
  geometry3d/            calibration, undistortion, ego-motion, polar warps
  training/              SGD training loops, criteria, scoring
  parallel/              device-mesh sharding (batch data-parallel)
  robotics/              drone API, simulator, occupancy depth maps, control
  utils/                 timers, visualization
"""

__version__ = "0.1.0"

# Shared persistent XLA compilation cache (utils/compcache.py): compiled
# executables make every later process start warm.
from .utils.compcache import enable_persistent_cache as _enable_cache

_enable_cache()
del _enable_cache

from .geometry import Geometry, Learning  # noqa: F401
