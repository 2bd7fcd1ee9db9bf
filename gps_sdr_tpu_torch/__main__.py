"""`python -m gps_sdr_tpu_torch` — CLI launcher (see gps_sdr_tpu_torch/cli.py)."""

import sys

from gps_sdr_tpu_torch.cli import main

sys.exit(main())
