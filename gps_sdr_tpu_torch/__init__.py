"""gps_sdr_tpu_torch — the GPS L1 C/A receiver on PyTorch and CUDA.

A port of `gps_sdr_tpu` (JAX/Pallas) to PyTorch, with hand-written
Hopper (sm_90a) CUDA kernels in place of every Pallas kernel.  The JAX
package stays the reference; each module here keeps its counterpart's
name and public functions at the same relative path, except where
noted:

  ops/dsp.py, ops/corr.py      DSP primitives and the tracking
                               correlator on torch.fft
  ops/acquisition.py           full-grid cold-start acquisition
  ops/frontend.py              FIR decimation (conv1d), DDC, CW
                               excision (torch.fft)
  ops/snapshot.py              coarse-time snapshot fix from one block
  ops/tracking.py              channel state, K=1 and K-fused tracking,
                               compact transport, window program
  ops/hopper_wipeoff.py        mix + code-wipeoff kernels:
                               csrc/wipeoff.cu (for pallas_kernels.py
                               _mxu_wipeoff_kernel) and
                               csrc/wipeoff_vpu.cu (for
                               _mix_wipeoff_kernel)
  ops/hopper_cheap.py          K-block cheap-stage kernel (csrc/cheap.cu,
                               for pallas_cheap.py _cheap_kernel)
  ops/kstep_graphs.py          the K-fused loop's steps replayed as
                               CUDA graphs on the card (no JAX
                               counterpart: XLA compiles the loop)
  models/scenario_dev.py       device scenario synthesis
                               (models/scenario_jax.py)
  models/sim_dev.py            DeviceSynth, device parametric synthesis
                               (models/sim_jax.py JaxSynth)
  runtime/receiver.py          Receiver: run (host-fed) and run_device
                               (device-resident)
  runtime/session.py           Session
  runtime/serving.py           StreamServer: S receivers on one card,
                               the stream axis in the kernels' grids,
                               or split over a stream mesh
  runtime/checkpoint.py        session and server checkpoints
  parallel/                    device meshes (mesh.py: time x ch and
                               stream meshes, one device repeatable,
                               multi-process over torch.distributed),
                               sharded acquisition (acquisition.py) and
                               time/channel-sharded tracking with exact
                               or state-handoff stitching (tracking.py)
  utils/profiling.py           span() and count(): the program's
                               stage timings and counters, in the
                               profiler's trace while one runs;
                               trace() over torch.profiler and the
                               trace's device time and per-op
                               breakdown
  runtime/transport.py         the two-process topology's UDP wire
                               (the JAX package's pickle format)
  runtime/buffer.py            block buffers (deque, native ring)
  ui/plot.py                   the live matplotlib UI (imports
                               matplotlib only when made)
  cli.py                       every mode, role and UI of the JAX CLI:
                               `python -m gps_sdr_tpu_torch replay ...`
                               (with --input-rate), `synth`, `live`,
                               `epochs`, `eval`, `serve`, `snapshot`,
                               --role recv|eval, --ui plot

The host half is the port's own copy of the JAX package's JAX-free
modules, at the same relative paths, with their imports pointed here:
config, models/{almanac,atmosphere,ephemeris,navmsg,orbits,pseudorange,
scenario,simulator}, ops/{cacode,pvt}, runtime/{channelmgr,evaluator,
trackfilter,sources}, utils/{cplist,geodesy,gpstime,io,tuplelog},
ui/{headless,webmap}.  The native host
core is ported too: csrc/{evalcore,navscan,ingest}.cpp (copies of the
JAX package's C++), built by g++ at first use (nativecore.py) and bound
in _evalcore.py, models/_navscan.py and runtime/_native.py; the copies
dispatch to it where the JAX package does (GSDR_EVALCORE=0 and
GSDR_NAVSCAN=0 select the numpy paths), and a build or load that fails
raises.  Importing this package loads neither JAX nor any module of
gps_sdr_tpu, and builds nothing.
"""

__version__ = "0.1.0"

from gps_sdr_tpu_torch.config import ReceiverConfig  # noqa: F401
from gps_sdr_tpu_torch.models.sim_dev import DeviceSynth  # noqa: F401
