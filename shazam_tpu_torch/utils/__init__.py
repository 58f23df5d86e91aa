from ..profiling import device_trace

__all__ = ["device_trace"]
