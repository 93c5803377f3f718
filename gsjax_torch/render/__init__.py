"""The forward render path: preprocess, binning, compositing."""
