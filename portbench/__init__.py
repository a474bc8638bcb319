"""The benchmark of tpuvec_torch, the PyTorch and CUDA port: one command,
``python3 portbench/run.py``, driven by BENCHMARK.json and the data files
beside this one."""
