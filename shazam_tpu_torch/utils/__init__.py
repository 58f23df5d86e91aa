from .profiling import StageTimer, device_trace

__all__ = ["StageTimer", "device_trace"]
