from .harness import BenchConfig, run_recognition_sweep
from .report import generate_csv_results

__all__ = ["BenchConfig", "run_recognition_sweep", "generate_csv_results"]
