"""The host modules this package shares with the JAX package instead of
copying them: the config (one `Config` drives both packages), the synthetic
and KITTI data sources, the trajectory tools, the host-side map store of
the host driver and the visualisation writers. They are numpy-only and
import no jax; every other module of the port reaches them through here.
"""

from stereo_visual_slam_tpu.data import kitti, synthetic  # noqa: F401
from stereo_visual_slam_tpu.mapping.store import Keyframe, MapStore  # noqa: F401
from stereo_visual_slam_tpu.pipeline import trajectory, viz  # noqa: F401
from stereo_visual_slam_tpu.utils import config  # noqa: F401
from stereo_visual_slam_tpu.utils.config import (  # noqa: F401
    BAConfig, Config, reference_ba_schedule, small_config,
)


def config_from_yaml(path: str, base: Config) -> Config:
    """`base` with the overrides of a YAML file (utils/config_io.py). Its
    module imports yaml, which only this call needs."""
    from stereo_visual_slam_tpu.utils import config_io

    return config_io.config_from_yaml(path, base)
