from . import base, geometric, lidar_iris, m2dp, registry, scan_context, shot

__all__ = ["base", "geometric", "lidar_iris", "m2dp", "registry", "scan_context", "shot"]
