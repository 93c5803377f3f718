"""The render path and its backward: preprocess, binning, compositing."""
