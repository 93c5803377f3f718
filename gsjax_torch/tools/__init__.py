"""The port's profiling tools, run on the card with `python -m`:
probe_prims (instance-rate primitives), probe_outpath (the forward's output
layout), ablate_kernels (the composite kernels taken apart), time_composite
and profile_binning (the composite kernels and binning's stages alone),
profile_kernels (both at the trainer's 16x16 tiles), bench_fps and
bench_trained (forward and viewer throughput, on the bench scene and on a
trained PLY), bench_sweep (tile x chunk x strips), trace_step and
trace_binning (torch.profiler traces split by op and family), bench_scan
(the bench step dispatched against replays of its captured graph),
probe_gradreduce (the grad reduction's pieces), probe_saturation (the
view's final transmittance), probe_tilesize (pairs per tile shape),
bench_mesh_overhead and bench_scaling (the sharded step on one card and
per mesh shape), scaling_projection (t(data, tile) from one card's
stages). And the runs and files around training: quality_run (with the
quality artifact), diagnose_quality (its diagnosis), sky_run (the sky
shell with and without), ckpt_to_ply and export_lpips_weights. Their
kernels are in tools/kernels.py; the bench scene and the timing helpers
they share with gsjax_torch.bench, gsjax_torch.profile_stages and
chip_smoke.py are in tools/common.py, the trace reading in tools/trace.py."""
