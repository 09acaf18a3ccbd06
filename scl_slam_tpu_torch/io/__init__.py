from . import kitti, trajectory

__all__ = ["kitti", "trajectory"]
