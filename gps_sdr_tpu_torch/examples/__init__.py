"""The JAX package's examples on PyTorch: synthetic_fix.py (the quick
start's closed loop), analysis.py with analysis.ipynb (the evaluation
notebook and its live receiver), and the long-run stress tools soak.py
and endurance.py."""
