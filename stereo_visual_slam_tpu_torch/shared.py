"""The host modules this package shares with the JAX package instead of
copying them: the config (one `Config` drives both packages), the synthetic
and KITTI data sources and the trajectory tools. They are numpy-only and
import no jax; every other module of the port reaches them through here.
"""

from stereo_visual_slam_tpu.data import kitti, synthetic  # noqa: F401
from stereo_visual_slam_tpu.pipeline import trajectory  # noqa: F401
from stereo_visual_slam_tpu.utils import config  # noqa: F401
from stereo_visual_slam_tpu.utils.config import (  # noqa: F401
    BAConfig, Config, small_config,
)
