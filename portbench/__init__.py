"""The benchmark of sdpb_tpu_torch, the PyTorch and CUDA port: run one
cell with ``python3 portbench/run.py``; the manifest is BENCHMARK.json
at the root of the repository."""
