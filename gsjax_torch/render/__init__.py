"""The render path and its backward: preprocess, binning, compositing.

Re-exports gsjax's names. As in gsjax, the package's `preprocess` is the
function, which hides the module of that name: reach the module with
`from gsjax_torch.render.preprocess import ...`."""

from gsjax_torch.render.api import RenderOutput, render
from gsjax_torch.render.preprocess import Projected, preprocess

__all__ = ["render", "RenderOutput", "preprocess", "Projected"]
