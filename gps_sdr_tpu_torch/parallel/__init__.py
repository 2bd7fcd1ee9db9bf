"""Multi-device sharding on PyTorch: mesh construction, sharded
acquisition (Doppler x PRN grid over devices) and sharded tracking
(channels over a mesh axis; long streams over time shards with carry
stitching).  Port of gps_sdr_tpu/parallel; a mesh may repeat one device
and may span processes (torch.distributed)."""

from gps_sdr_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from gps_sdr_tpu_torch.parallel.acquisition import (  # noqa: F401
    acquire_sharded)
from gps_sdr_tpu_torch.parallel.tracking import (  # noqa: F401
    track_sharded, pad_channels)
