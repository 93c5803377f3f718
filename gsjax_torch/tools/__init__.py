"""The port's profiling tools, run on the card with `python -m`:
probe_prims (instance-rate primitives), probe_outpath (the forward's output
layout), ablate_kernels (the composite kernels taken apart). Their kernels
are in tools/kernels.py; the bench scene and the timing helpers they share
with gsjax_torch.bench, gsjax_torch.profile_stages and chip_smoke.py are in
tools/common.py."""
