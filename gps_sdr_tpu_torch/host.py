"""Host-side pieces the port shares with gps_sdr_tpu, in one place.

The receiver's configuration, the C/A code tables and the signal
oracles (the per-satellite simulator and the physical scenario) are
numpy code in gps_sdr_tpu's JAX-free modules.  The port uses them as
they are, so the same configuration, codes and IQ feed both packages;
scripts that drive the port, such as chip_smoke.py, take them from here.
"""

from gps_sdr_tpu.config import ReceiverConfig  # noqa: F401
from gps_sdr_tpu.models.scenario import (Scenario,  # noqa: F401
                                         make_scenario,
                                         synth_scenario_blocks)
from gps_sdr_tpu.models.simulator import (SatSignal,  # noqa: F401
                                          random_bits, synth_stream)
from gps_sdr_tpu.ops.cacode import ca_fft_table, ca_table  # noqa: F401
