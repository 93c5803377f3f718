"""Command-line entry points: `python -m gsjax_torch.cli.<name>` for
train, render, metrics, full_eval and convert."""
