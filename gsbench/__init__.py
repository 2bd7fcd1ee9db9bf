"""The benchmark of gps_sdr_tpu_torch, the receiver's PyTorch and CUDA
port, on NVIDIA H100 cards.

BENCHMARK.json at the repository root names its cells: a configuration
(configs/<name>.json, a deployment of the receiver) under a traffic mix
(traffic/<name>.json, the captures one generator makes from the run's
seed).  `python3 -m gsbench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>` runs one cell once (run.py); metrics/<name>.py reads
each metric; reference.py is the plain reference the answers are
judged against (judge.py), and control.py its control.  Nothing here
imports JAX or the JAX package gps_sdr_tpu; the generator, the
reference, the work counts and the trace arithmetic import nothing of
the receiver either.
"""
