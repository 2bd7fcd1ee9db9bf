"""The JAX package's examples on PyTorch: synthetic_fix.py (the quick
start's closed loop), analysis.py with analysis.ipynb (the evaluation
notebook and its live receiver), the long-run stress tools soak.py and
endurance.py, and the analysis tools: roofline.py (the K-fused step's
device time by stage against work_per_block's floor),
probe_device_loop.py, profile_fullloop.py, profile_serving.py,
profile_evalhost.py (where the host's time goes) and scaling_sweep.py
(the time-shard stitch modes)."""
