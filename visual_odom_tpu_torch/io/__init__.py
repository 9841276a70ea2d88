"""Input: KITTI sequences and pose files, cameras, synthetic stereo
courses, gyro logs, and the native PNG decoder and prefetcher."""

from visual_odom_tpu_torch.io.camera import (CameraSource, FakeCamera,
                                             ImageDirCamera)
from visual_odom_tpu_torch.io.kitti import (KittiSequence, load_poses,
                                            save_poses_kitti)
from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence

__all__ = [
    "KittiSequence",
    "load_poses",
    "save_poses_kitti",
    "CameraSource",
    "FakeCamera",
    "ImageDirCamera",
    "SyntheticStereoSequence",
]
