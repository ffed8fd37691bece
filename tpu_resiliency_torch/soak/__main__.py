"""``python -m tpu_resiliency_torch.soak``: the chaos soak (``launcher.py``)."""

import sys

from .launcher import main

if __name__ == "__main__":
    sys.exit(main())
