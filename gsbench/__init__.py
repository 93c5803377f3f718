"""The benchmark of gsjax_torch (the PyTorch/CUDA port of gsjax).

One run measures one cell of BENCHMARK.json: `python3 gsbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`. Everything a
cell needs is found by name: its configuration in `configs/<config>.json`,
its traffic mix in `traffic/<mix>.json` (read by the generator the mix
names in `drivers/`), each per-layer metric's reader in
`metrics/<metric>.py` and the limits of its output check in
`limits/<cell>.json`. The plain reference (`reference/`) imports nothing
of the port.
"""
