"""The port's profiling tools, run on the card with `python -m`:
probe_prims (instance-rate primitives), probe_outpath (the forward's output
layout), ablate_kernels (the composite kernels taken apart), time_composite
and profile_binning (the composite kernels and binning's stages alone),
profile_kernels (both at the trainer's 16x16 tiles), bench_fps and
bench_trained (forward and viewer throughput, on the bench scene and on a
trained PLY), bench_sweep (tile x chunk x strips), trace_step and
trace_binning (torch.profiler traces split by op and family). Their
kernels are in tools/kernels.py; the bench scene and the timing helpers
they share with gsjax_torch.bench, gsjax_torch.profile_stages and
chip_smoke.py are in tools/common.py, the trace reading in tools/trace.py."""
