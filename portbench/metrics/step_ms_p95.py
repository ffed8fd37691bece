"""95th percentile of the gap between consecutive steps' end events (CUDA
events recorded after each step of the window, read after it closes)."""

import numpy as np


def read(run):
    return float(np.percentile(run.step_gaps_ms, 95)) if run.step_gaps_ms else None
