"""gps_sdr_tpu_torch — the GPS L1 C/A receiver on PyTorch and CUDA.

A port of `gps_sdr_tpu` (JAX/Pallas) to PyTorch, with hand-written
Hopper (sm_90a) CUDA kernels in place of the Pallas kernels of the
replay path.  The JAX package stays the reference; each module here
keeps its counterpart's name and public functions at the same relative
path:

  ops/dsp.py, ops/corr.py      DSP primitives and the tracking
                               correlator on torch.fft
  ops/acquisition.py           full-grid cold-start acquisition
  ops/tracking.py              channel state, K=1 and K-fused tracking
  ops/hopper_wipeoff.py        mix + code-wipeoff kernel (csrc/wipeoff.cu)
  ops/hopper_cheap.py          K-block cheap-stage kernel (csrc/cheap.cu)
  runtime/receiver.py          Receiver (replay path)
  runtime/session.py           Session
  cli.py                       `python -m gps_sdr_tpu_torch replay ...`
  host.py                      config, C/A tables and signal oracles,
                               for scripts such as chip_smoke.py

The host half (config, nav decode, evaluator, fixes, I/O, reporters)
is imported from `gps_sdr_tpu`'s JAX-free modules and never copied.
Importing this package loads no JAX.
"""

__version__ = "0.1.0"

from gps_sdr_tpu.config import ReceiverConfig  # noqa: F401
