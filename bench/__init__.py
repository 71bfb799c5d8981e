"""The benchmark of the PyTorch and CUDA port (`BENCHMARK.json`):
`python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace
<0|1>` runs one cell once. See bench/README.md."""
